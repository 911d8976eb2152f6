"""The port's federated plane (``optim/compress.py``, ``optim/fed.py``,
``serving/train_plane.py``, and ``SimFleet``'s fed rounds) against the
reference, on the cases of test_fed.py.

Every case runs on each package.  The model-free ones (SimFleet, the FEDR
frames, ``fed_avg``) compare the results exactly: snapshots field by field,
frames byte for byte in both directions (each package decodes the other's
frame to its own decoded values).  The coordinator runs reduced granite
(2 layers, fp32) on both packages from one set of weights: the reference
draws its trained params from ``jax.random.key(seed)`` (its ``params=None``
path) and the port is handed the same values through ``params_from_jax``.

A local step is held to the reference's within ``PARAM_TOL`` (fp32).
Everything discrete in a round (who was selected, delivered, excluded;
sample counts) is compared exactly.  Over several rounds the two packages'
trained params cannot be held within fp32 tolerance of each other: their
local deltas differ by fp32 rounding, and quantising them is
discontinuous, so an entry near an int8 rounding midpoint, a bf16 one or
the top-k threshold lands on the other side in one package (a flip), and
the next round starts from other params.  So the reference runs forced by
the port's delivered updates (``_forced_run``): each round it aggregates
the port's frames, so both packages start every round from the same
params.  Then every round's losses agree within 1e-5, the trained params
within ``PARAM_TOL``, and the frames each package delivered agree entry by
entry but for the flips, which must be few and small (``_check_frames``).
"""
import importlib
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import leaves, params_from_jax, stack_blocks, tree_map
from test_torch_fleet import _pair, one_thread  # noqa: F401
from test_torch_scale import same

PACKAGES = ("repro", "repro_torch")
MODULES = ("data.synthetic", "hw.specs", "runtime.faults", "runtime.trainer", "serving.failover",
           "serving.fleet", "serving.metrics", "serving.scale", "serving.train_plane")
# params, port vs reference, |err| <= PARAM_TOL * max(1, |ref|): fp32
# local steps whose gradients differ in summation order
PARAM_TOL = 1e-5
# the share of a leaf's entries that may cross a quantisation boundary in
# one package and not the other over a test's rounds
MAX_FLIP_SHARE = 0.01


def _ns(pkg: str) -> SimpleNamespace:
    ns = SimpleNamespace(pkg=pkg)
    for m in MODULES:
        mod = importlib.import_module(f"{pkg}.{m}")
        for name in dir(mod):
            if not name.startswith("__"):
                setattr(ns, name, getattr(mod, name))
    ns.fed = importlib.import_module(f"{pkg}.optim.fed")
    ns.compress = importlib.import_module(f"{pkg}.optim.compress")
    return ns


@pytest.fixture(scope="module")
def both():
    return [_ns(pkg) for pkg in PACKAGES]


def _on_cpu(m) -> dict:
    """The port's decode and aggregation run on the card unless told
    otherwise; the reference's take no device."""
    return {} if m.pkg == "repro" else {"device": "cpu"}


def on_both(both, scenario):
    ref, port = (scenario(m) for m in both)
    assert same(port, ref), (port, ref)
    return port


# ---------------------------------------------------------------------------
# SimFleet's fed rounds (model-free)
# ---------------------------------------------------------------------------

def _sim_fleet(m, fed, impl="vector", n=4, kill_trace=None):
    prof = m.DeviceProfile(name="sim", year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=20.0, prefill_tokens_per_s=2000.0,
                           thermal_sustained=0.85, thermal_tau_s=60.0)
    spec = m.ScaleWorkerSpec(profile=prof, max_batch=4, max_queue=16)
    return m.SimFleet(m.make_rows(spec, n), tick_s=0.05, slo=(m.SLOClass("default"),),
                      admission=False, fed=fed, impl=impl, kill_trace=kill_trace,
                      detect_s=0.5, ckpt_every_s=0.5)


def _run_rounds(fleet, rounds, max_ticks=50_000):
    while fleet.fed_rounds < rounds and fleet.ticks < max_ticks:
        fleet.tick()
    return fleet.snapshot()


def test_sim_fed_rounds_complete_and_account(both):
    def scenario(m):
        fed = m.FedSimConfig(rounds=3, participants=2, local_steps=2, step_tokens=200,
                             frame_bytes=1 << 16)
        snap = _run_rounds(_sim_fleet(m, fed), 3)
        assert snap.fed_rounds == 3 and snap.fed_deliveries == 6 and snap.fed_excluded == 0
        assert snap.fed_wire_bytes == 6 * (1 << 16) and snap.fed_samples == 6 * 2 * 200
        assert snap.fed_train_s >= 6 * (2 * fed.flops_mult * 200 / 2000.0) * 0.99
        return snap
    on_both(both, scenario)


def test_sim_fed_loop_vector_bit_identical(both):
    def scenario(m):
        fed = m.FedSimConfig(rounds=3, participants=2, local_steps=2, step_tokens=500,
                             frame_bytes=1 << 18)
        a = _run_rounds(_sim_fleet(m, fed, "loop"), 3)
        b = _run_rounds(_sim_fleet(m, fed, "vector"), 3)
        assert a == b
        return a
    on_both(both, scenario)


def test_sim_fed_off_is_inert(both):
    def scenario(m):
        fleet = _sim_fleet(m, None)
        for _ in range(50):
            fleet.tick()
        snap = fleet.snapshot()
        assert snap.fed_rounds == snap.fed_deliveries == snap.fed_excluded == 0
        assert snap.fed_train_s == 0.0 and snap.fed_wire_bytes == 0
        assert snap.fed_preempt_ticks == 0
        return snap
    on_both(both, scenario)


def test_sim_fed_training_heats_the_row(both):
    def scenario(m):
        fed = m.FedSimConfig(rounds=4, participants=1, local_steps=4, step_tokens=4000,
                             frame_bytes=1 << 16)
        hot, cold = _sim_fleet(m, fed), _sim_fleet(m, None)
        for _ in range(400):
            hot.tick()
            cold.tick()
        assert hot.fed_train_s > 0
        assert hot.snapshot().heat_max > cold.snapshot().heat_max
        return hot.snapshot(), cold.snapshot()
    on_both(both, scenario)


def test_sim_fed_detected_kill_excludes_participant(both):
    def scenario(m):
        fed = m.FedSimConfig(rounds=2, participants=2, local_steps=2, step_tokens=5_000,
                             frame_bytes=1 << 16, round_timeout_s=120.0)
        trace = m.KillTrace((m.KillEvent(t_s=2.0, worker=0, kind="crash", down_s=math.inf),))
        snap = _run_rounds(_sim_fleet(m, fed, kill_trace=trace), 2)
        assert snap.fed_rounds == 2 and snap.fed_excluded >= 1
        assert snap.fed_deliveries >= 2 and snap.deaths == 1
        return snap
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# FEDR frames and aggregation
# ---------------------------------------------------------------------------

def _delta_values():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}


def _tree(m, values: dict):
    """``values`` as the package's tree: jnp arrays or CPU tensors."""
    if m.pkg == "repro":
        return {k: jnp.asarray(v) for k, v in values.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in values.items()}


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode,topk", [("int8_ef", 0.5), ("int8_ef", None), ("bf16", None)],
                         ids=["int8_ef-topk", "int8_ef", "bf16"])
def test_fed_frames_byte_equal_both_directions(both, mode, topk):
    """The same delta gives the same FEDR frame in both packages, and each
    package decodes the other's frame to the values it decodes its own to;
    in int8_ef mode the residuals agree too, and delta = decoded + residual
    (the reference's round-trip case)."""
    ref, port = both
    frames, errs = {}, {}
    for m in both:
        frames[m.pkg], err = m.fed.encode_update(_tree(m, _delta_values()), mode=mode,
                                                 topk_frac=topk)
        errs[m.pkg] = None if err is None else _np(err)
    assert frames["repro_torch"] == frames["repro"]
    assert frames["repro"][:4] == ref.fed.FED_MAGIC == port.fed.FED_MAGIC
    for m in both:
        own, other = (_np(m.fed.decode_update(frames[p], **_on_cpu(m)))
                      for p in (m.pkg, "repro"))
        assert same(own, other)
        for k, v in _delta_values().items():
            if mode == "bf16":
                np.testing.assert_allclose(own[k], v, rtol=1e-2, atol=1e-2)
            else:
                np.testing.assert_allclose(v, own[k] + errs[m.pkg][k], atol=1e-6)
    assert same(errs["repro_torch"], errs["repro"])


def test_fed_frame_rejects_garbage(both):
    for m in both:
        frame, _ = m.fed.encode_update(_tree(m, _delta_values()), mode="int8_ef")
        for bad in (b"NOPE" + frame[4:], frame[:4] + bytes([99]) + frame[5:], frame[:6]):
            with pytest.raises(m.fed.FedWireError):
                m.fed.decode_update(bad, **_on_cpu(m))
        with pytest.raises(ValueError):
            m.fed.encode_update(_tree(m, _delta_values()), mode="float8")


def test_fed_avg_is_sample_weighted_and_order_free(both):
    def scenario(m):
        d1 = _tree(m, {"w": np.asarray([1.0, 2.0], np.float32)})
        d2 = _tree(m, {"w": np.asarray([3.0, 4.0], np.float32)})
        u1 = m.fed.ClientUpdate("a", 1, m.fed.encode_update(d1, mode="bf16")[0])
        u2 = m.fed.ClientUpdate("b", 3, m.fed.encode_update(d2, mode="bf16")[0])
        avg = _np(m.fed.fed_avg([u1, u2], **_on_cpu(m)))
        rev = _np(m.fed.fed_avg([u2, u1], **_on_cpu(m)))
        np.testing.assert_allclose(avg["w"], [2.5, 3.5], atol=1e-6)
        assert np.array_equal(avg["w"], rev["w"])
        assert m.fed.fed_avg([], **_on_cpu(m)) is None
        with pytest.raises(ValueError):
            m.fed.fed_avg([u1, m.fed.ClientUpdate("a", 2, u1.frame)], **_on_cpu(m))
        with pytest.raises(ValueError):
            m.fed.fed_avg([m.fed.ClientUpdate("a", 0, u1.frame)], **_on_cpu(m))
        return u1.frame, u2.frame, avg
    on_both(both, scenario)


def test_topk_error_feedback_carries_dropped_mass(both):
    def scenario(m):
        g = _tree(m, {"w": np.asarray([10.0, -8.0, 0.2, -0.1], np.float32)})
        q, s, e2 = m.compress.compress_tree(g, m.compress.init_error(g), topk_frac=0.5)
        assert np.count_nonzero(np.asarray(q["w"])) == 2
        deq = np.asarray(m.compress.decompress_tree(q, s)["w"])
        np.testing.assert_allclose(np.asarray(e2["w"])[2:], [0.2, -0.1], atol=1e-5)
        np.testing.assert_allclose(deq[:2], [10.0, -8.0], atol=10.0 / 127)
        return _np(q), _np(s), _np(e2)
    on_both(both, scenario)


def test_error_feedback_frames_byte_equal_over_rounds(both):
    """Three rounds of int8_ef top-k frames, each package threading its own
    error-feedback state: the frames are byte-equal round by round (not
    merely within a quantum), because the residual is the same fp32
    arithmetic in both, so the same entries cross the top-k threshold and
    round the same way each round; the dropped mass reappears in later
    rounds' frames."""
    rng = np.random.default_rng(5)
    grads = [{"w": rng.normal(size=(32, 16)).astype(np.float32),
              "b": (rng.normal(size=(16,)) * 1e-3).astype(np.float32)} for _ in range(3)]

    def scenario(m):
        err, frames = None, []
        for g in grads:
            frame, err = m.fed.encode_update(_tree(m, g), mode="int8_ef", error=err,
                                             topk_frac=0.25)
            frames.append(frame)
        decoded = [_np(m.fed.decode_update(f, **_on_cpu(m))) for f in frames]
        # entries dropped in round 0 cross in a later round's frame
        dropped = decoded[0]["w"] == 0
        assert (dropped & (decoded[1]["w"] != 0)).any()
        return frames, _np(err)
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# FedRoundCoordinator on a real fleet (reduced granite, fp32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fed_both(both):
    """The namespaces with the serving model and params, and the params the
    coordinator trains: the reference's ``params=None`` draw
    (``jax.random.key(0)``), handed to the port converted."""
    granite = _pair("granite-8b", 2, 0)
    model = granite[0]
    init = params_from_jax(jax.tree.map(np.asarray, model.init(jax.random.key(0))),
                           device="cpu")
    out = []
    for i, m in enumerate(both):
        ns = SimpleNamespace(**vars(m))
        ns.lm = granite[2 * i:2 * i + 2]
        ns.fed_init = None if m.pkg == "repro" else init
        out.append(ns)
    return out


def _coord_profile(m, name):
    return m.DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=20.0, prefill_tokens_per_s=2000.0)


def _coord(m, rounds=2, kill_trace=None, **cfg_kw):
    model, params = m.lm
    workers = [m.WorkerSpec(n, _coord_profile(m, f"dev-{n}"), max_batch=4)
               for n in ("a", "b", "c")]
    fleet = m.ServingFleet(model, params, workers, max_len=48, tick_s=0.05,
                           kill_trace=kill_trace,
                           failover=m.FailoverConfig(checkpoint_every_s=0.5)
                           if kill_trace is not None else None)
    fc = m.FedConfig(rounds=rounds, local_steps=2, participants=2, batch=2, seq_len=16,
                     lr=0.3, seed=0, **cfg_kw)
    return m.FedRoundCoordinator(fleet, model, fc, params=m.fed_init)


def _port_layout(m, params):
    """Trained params as the port's tree of numpy arrays."""
    if m.pkg == "repro":
        params = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return tree_map(lambda t: t.detach().numpy(), params)


def _rounds_view(rounds) -> list:
    """The discrete fields of each ``FedRoundSnapshot`` (compared exactly),
    and its two losses (compared within tolerance by the caller)."""
    return [(r.round_id, r.participants, r.delivered, r.excluded, r.samples)
            for r in rounds]


def _check_params(got: dict, want: dict) -> None:
    """Every entry within PARAM_TOL x max(1, |ref|)."""
    for g, w in zip(leaves(got), leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL * max(1.0, np.abs(w).max()))


def _recording(m, forced=None):
    """Wrap the package's ``fed_avg`` so each round's delivered updates are
    kept; returns the list it appends to.  With ``forced`` (the port's
    delivered updates a round) round r aggregates ``forced[r]`` instead of
    the package's own updates, so the package's params follow the port's
    round by round."""
    rounds, inner = [], m.fed.fed_avg

    def fed_avg(updates, *args, **kw):
        rounds.append(list(updates))
        return inner(updates if forced is None else forced[len(rounds) - 1], *args, **kw)
    m.fed.fed_avg = fed_avg
    m.restore = lambda: setattr(m.fed, "fed_avg", inner)
    return rounds


def _rounding_unit(a: np.ndarray, mode: str, topk) -> float:
    """One rounding unit of a decoded leaf ``a``: int8, the quantum
    max|a| / 127, plus with top-k the smallest kept magnitude (where the
    threshold sat: an entry that crosses it moves by that much and a
    quantum); bf16, 2^-7 max|a|, bf16's spacing relative to the leaf's
    largest value."""
    a = np.abs(a)
    if mode == "bf16":
        return float(a.max()) * 2.0 ** -7
    kept = a[a > 0]
    return float(a.max()) / 127 + (float(kept.min()) if topk and kept.size else 0.0)


def _check_frames(ref, own: list, port, delivered: list, mode: str, topk) -> None:
    """The frames the two packages delivered a round, compared element-wise
    after decoding.  The reference ran forced by the port's updates, so in
    every round both packages trained from the same params, and their
    deltas differ only by fp32 rounding; the frames then differ only where
    an entry crossed a quantisation boundary (an int8 rounding midpoint, a
    bf16 one, the top-k threshold) in one package and not the other: a
    flip.  An entry is flipped when its decoded values differ by more than
    PARAM_TOL x the leaf's largest decoded value.  Flips must stay under
    MAX_FLIP_SHARE of every leaf, and each within one rounding unit of its
    frame, plus in int8_ef mode one unit of the participant's previous
    frame: a flip leaves the two packages' residuals that far apart, and
    the next frame carries them.  A fault in the port's round (error
    feedback not carried, a local step that wrote the global params) moves
    most entries of a frame."""
    assert len(own) == len(delivered)
    carried = {}                   # participant -> its last frame's units
    for r, (ups_ref, ups_port) in enumerate(zip(own, delivered)):
        ups_ref, ups_port = (sorted(u, key=lambda u: u.name) for u in (ups_ref, ups_port))
        assert [(u.name, u.samples) for u in ups_ref] == [(u.name, u.samples) for u in ups_port]
        for ur, up in zip(ups_ref, ups_port):
            # in the frame's own layout, where each leaf has its int8 scale
            dec_ref = [np.asarray(x) for x in jax.tree.leaves(ref.fed.decode_update(ur.frame))]
            dec_port = [x.numpy() for x in leaves(port.fed.decode_update(up.frame,
                                                                          device="cpu"))]
            units = [_rounding_unit(a, mode, topk) for a in dec_ref]
            prev = carried.get(ur.name, [0.0] * len(units)) if mode == "int8_ef" else None
            for i, (a, b) in enumerate(zip(dec_ref, dec_port)):
                diff, tol = np.abs(a - b), PARAM_TOL * np.abs(a).max()
                flip = diff > tol
                where = f"round {r}, {ur.name}, leaf {i}"
                assert flip.mean() <= MAX_FLIP_SHARE, \
                    f"{where}: {int(flip.sum())} of {flip.size} entries flipped"
                bound = units[i] + (prev[i] if prev else 0.0) + tol
                assert (diff <= bound).all(), f"{where}: a flip of {diff.max()} > {bound}"
            carried[ur.name] = units


def _forced_run(fed_both, run):
    """``run(m)`` -> (coordinator, rounds) on the port, recording its
    delivered updates, then on the reference forced by them.  Returns
    [(rounds, params, own updates), ...], the reference's first."""
    ref, port = fed_both
    out = {}
    for m in (port, ref):
        own = _recording(m, None if m is port else out["repro_torch"][2])
        try:
            coord, rounds = run(m)
        finally:
            m.restore()
        out[m.pkg] = (rounds, _port_layout(m, coord.params), own)
    return out["repro"], out["repro_torch"]


def test_local_sgd_step_matches_the_reference(fed_both):
    """One local step (loss, autograd, ``p - lr g`` in fp32) from the same
    params and batch: the new params within PARAM_TOL, the loss within
    1e-5."""
    ref, port = fed_both
    model, tmodel = ref.lm[0], port.lm[0]
    params = model.init(jax.random.key(0))
    batch = ref.TokenPipeline(ref.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                                             global_batch=2, seed=0)).batch(0)
    new, _, rec = ref._local_sgd_step(model, 0.3)(params, {}, batch)
    tnew, _, trec = port._local_sgd_step(tmodel, 0.3)(port.fed_init, {}, batch)
    assert float(trec["loss"]) == pytest.approx(float(rec["loss"]), rel=1e-5)
    _check_params(_port_layout(port, tnew), _port_layout(ref, new))


@pytest.mark.parametrize("mode,topk", [("int8_ef", 0.5), ("int8_ef", None), ("bf16", None)],
                         ids=["int8_ef-topk", "int8_ef", "bf16"])
def test_coordinator_runs_rounds_and_loss_descends(fed_both, mode, topk):
    """The reference's three rounds, in each frame mode: the loss falls and
    the same participants deliver in both packages.  The reference runs
    forced by the port's delivered updates (``_forced_run``), so every
    round starts both from the same params: each round's losses agree
    within 1e-5, its frames agree but for a few flips (``_check_frames``)
    and the trained params within PARAM_TOL."""
    def run(m):
        coord = _coord(m, rounds=3, mode=mode, topk_frac=topk)
        rounds = coord.run_rounds()
        assert len(rounds) == 3 and coord.rounds_done == 3
        assert all(len(r.delivered) == 2 for r in rounds)
        assert rounds[-1].loss_last < rounds[0].loss_first
        assert coord.train_s_total > 0 and coord.wire_bytes_total > 0
        assert rounds[0].t_end <= rounds[1].t_begin
        return coord, rounds
    (r_ref, p_ref, own), (r_port, p_port, delivered) = _forced_run(fed_both, run)
    assert _rounds_view(r_port) == _rounds_view(r_ref)
    for got, want in zip(r_port, r_ref):
        assert got.loss_first == pytest.approx(want.loss_first, rel=1e-5)
        assert got.loss_last == pytest.approx(want.loss_last, rel=1e-5)
    _check_frames(fed_both[0], own, fed_both[1], delivered, mode, topk)
    _check_params(p_port, p_ref)


def test_coordinator_replay_is_bit_deterministic(fed_both):
    """Two seeded replays of two default (int8_ef, top-k) rounds give
    bit-identical frames and params in the port, and in the reference
    forced by each replay's updates; across the packages the rounds, frames
    and params agree as in the test above."""
    def run(m):
        coord = _coord(m, rounds=2)
        return coord, coord.run_rounds()
    first, second = _forced_run(fed_both, run), _forced_run(fed_both, run)
    for (r_ref, p_ref, own), (r_port, p_port, delivered) in (first, second):
        assert _rounds_view(r_port) == _rounds_view(r_ref)
        _check_frames(fed_both[0], own, fed_both[1], delivered, "int8_ef", 0.5)
        _check_params(p_port, p_ref)
    for one, two in zip(first, second):
        assert _rounds_view(one[0]) == _rounds_view(two[0])
        assert all(np.array_equal(x, y) for x, y in zip(leaves(one[1]), leaves(two[1])))
        assert [[u.frame for u in ups] for ups in one[2]] == \
            [[u.frame for u in ups] for ups in two[2]]


def test_local_steps_leave_the_global_params_unchanged(fed_both):
    """The in-place trap: every participant starts its round from the
    global params; a local step that wrote them would train the global
    params, and the next participant would start from the first one's
    result.  After a round's local steps (run eagerly when the round
    starts) the global params are bit-equal to before, and the second
    participant's delta equals the one it computes alone."""
    m = fed_both[1]
    coord = _coord(m, rounds=1)
    before = [t.clone() for t in leaves(coord.params)]
    coord.tick()                               # selects a and b, trains both
    assert [p.name for p in coord._active] == ["a", "b"]
    assert all(torch.equal(x, y) for x, y in zip(leaves(coord.params), before))
    alone = _coord(m, rounds=1)
    alone._eligible = lambda w: w.name == "b"  # b trains alone, from the same params
    alone.tick()
    assert [p.name for p in alone._active] == ["b"]
    assert alone._active[0].frame == coord._active[1].frame


def test_serving_tokens_identical_with_training_on(fed_both):
    def scenario(m):
        model, _ = m.lm
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, model.cfg.vocab_size, size=5 + i).astype(np.int32)
                   for i in range(6)]
        arrivals = np.linspace(0.0, 0.4, len(prompts))

        def serve(target):
            m.drive_sim(target, arrivals, lambda i: target.submit(prompts[i], max_new=6))
            return {rec.req.rid: list(rec.req.out_tokens) for rec in target.completed}
        coord = _coord(m, rounds=2)
        with_training = serve(coord)
        assert with_training == serve(_coord(m, rounds=2).fleet)
        assert coord.rounds_done >= 1
        return with_training, coord.rounds_done
    on_both(fed_both, scenario)


def test_mid_round_kill_loses_zero_rounds(fed_both):
    def scenario(m):
        trace = m.KillTrace((m.KillEvent(t_s=0.15, worker="b", kind="crash",
                                         down_s=math.inf),))
        coord = _coord(m, rounds=2, kill_trace=trace)
        rounds = coord.run_rounds()
        assert coord.rounds_done == 2
        hit = [r for r in rounds if "b" in r.excluded]
        assert hit and all("b" not in r.delivered for r in hit)
        for r in hit:
            assert r.samples == len(r.delivered) * coord.cfg.local_steps * coord.cfg.batch
        return _rounds_view(rounds), coord.fleet.failure_log
    on_both(fed_both, scenario)


def test_partition_heal_before_deadline_contributes(fed_both):
    def scenario(m):
        trace = m.KillTrace((m.KillEvent(t_s=0.15, worker="b", kind="partition",
                                         down_s=0.3),))
        coord = _coord(m, rounds=2, kill_trace=trace)
        rounds = coord.run_rounds()
        assert coord.rounds_done == 2 and coord.exclusions == 0
        assert all(len(r.delivered) == 2 for r in rounds)
        return _rounds_view(rounds), coord.fleet.failure_log
    on_both(fed_both, scenario)


def test_trainer_clock_is_injectable(both):
    def scenario(m):
        ticks = iter([10.0, 10.5, 11.0, 11.25])
        tr = m.Trainer(m.TrainerConfig(worker_name="w0"),
                       lambda params, opt, batch: (params, opt, {"loss": 1.5}),
                       clock=lambda: next(ticks))
        recs = [tr.train_step({}, {}, None, step=s)[2]["step_s"] for s in (0, 1)]
        assert recs == [pytest.approx(0.5), pytest.approx(0.25)]
        assert [r["loss"] for r in tr.history] == [1.5, 1.5]
        return recs
    on_both(both, scenario)


# bench_fed.py's configuration, where its loss claim is made: 6 rounds of
# 2 participants x 2 local steps of 4 x 32 tokens, lr 0.3, on reduced
# granite (2 layers, fp32); its held-out batch is 8 x 32 tokens of another
# seed's stream.  The claim: int8_ef's held-out loss at most 0.005 above
# bf16's.
BENCH_SEEDS = tuple(range(6))
# held-out loss, port vs reference after the 6 rounds (measured within
# 4e-5 on the CPU; the flips move a few entries a round)
BENCH_LOSS_TOL = 2e-4


def _bench_heldout(m, model, params) -> float:
    held = m.TokenPipeline(m.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                                        global_batch=8, seed=7)).batch(999)
    if m.pkg == "repro_torch":
        held = {"tokens": torch.as_tensor(held["tokens"])}
    return float(np.asarray(model.loss(params, held)[0]))


@pytest.mark.parametrize("seed", BENCH_SEEDS)
def test_bench_fed_loss_gap_matches_the_reference(fed_both, seed):
    """bench_fed.py's train run from the init the port draws with ``seed``
    (the reference is handed it in its own layout), in both frame modes, on
    both packages: each mode's held-out loss after the rounds agrees within
    BENCH_LOSS_TOL, and so does int8_ef's gap to bf16.  bench_fed.py makes
    its claim at one init, jax.random.key(0); whether it holds at another
    init is asserted nowhere here, since both packages share the answer
    (run with ``-s`` for the gaps).  chip_smoke.py's fed phase holds the
    card to the port's CPU run at these inits."""
    ref, port = fed_both
    init = port.lm[0].init(seed)
    start = {"repro": jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                                         stack_blocks(init))),
             "repro_torch": init}
    loss = {}
    for m in fed_both:
        model = m.lm[0]
        for mode in ("int8_ef", "bf16"):
            workers = [m.WorkerSpec(n, _coord_profile(m, f"dev-{n}"), max_batch=4)
                       for n in ("a", "b", "c")]
            fleet = m.ServingFleet(model, start[m.pkg], workers, max_len=64, tick_s=0.05)
            fc = m.FedConfig(rounds=6, local_steps=2, participants=2, batch=4, seq_len=32,
                             lr=0.3, seed=0, mode=mode)
            coord = m.FedRoundCoordinator(fleet, model, fc, params=start[m.pkg])
            assert len(coord.run_rounds()) == 6
            loss[m.pkg, mode] = _bench_heldout(m, model, coord.params)
    gap = {pkg: loss[pkg, "int8_ef"] - loss[pkg, "bf16"] for pkg in PACKAGES}
    print(f"bench_fed seed {seed}: int8_ef less bf16 {gap['repro']:+.6f} (reference), "
          f"{gap['repro_torch']:+.6f} (port)")
    for mode in ("int8_ef", "bf16"):
        assert abs(loss["repro_torch", mode] - loss["repro", mode]) <= BENCH_LOSS_TOL
    assert abs(gap["repro_torch"] - gap["repro"]) <= BENCH_LOSS_TOL
