"""The port's speculative decoding against the JAX package (mirrors
test_speculative.py at its sizes).

Reduced granite (2 layers) with the reference's 1-layer misaligned draft of
key 3 and its aligned draft (layer 1's output projections zeroed, the
1-layer prefix drafting), reduced rwkv6 (2 layers) and reduced zamba2
(2 layers, so its shared-block ``ak``/``av`` slots go through the rollback
replay); fp32, the same weights through ``params_from_jax``, prompts from
seeded numpy generators.  Greedy tokens, every ``SpecReport`` field and the
metrics' ``spec_*`` counters must equal the JAX ``SpecEngine``'s; the
target-to-draft frame is wider by exactly the key field (the port's keys
are int64 ``(seed, counter)`` pairs, the reference's threefry uint32 key
data).  Stochastic lanes are held to the port's own ``ServeEngine``: the
port does not draw the reference's threefry bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced_config
from repro.models import lm as jlm
from repro.models.api import build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.sampling import Sampler as JaxSampler
from repro.serving.speculative import SpecEngine as JaxSpecEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.serving.backends import DenseBackend, RecurrentBackend
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.engine_api import REQUIRED_ATTRS, DecodeEngine
from repro_torch.serving.sampling import Sampler, SamplingParams
from repro_torch.serving.speculative import SpecEngine

MAX_LEN = 48
TOL = 1e-4
STOCH = SamplingParams(temperature=8.0, top_k=64, seed=11)
STOCH2 = SamplingParams(temperature=8.0, top_k=64, seed=99)
PAGED = dict(kv_blocks=10, kv_block_size=4)


def _pair(arch, n_layers, key, **over):
    """(jax model, jax params, port model, port params): one set of weights."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers, **over)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                               n_layers=n_layers, **over)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                   compute_dtype="float32", remat=False),
                          device="cpu")
    params = model.init(jax.random.key(key))
    return model, params, tmodel, _port(params)


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-8b", 2, 0)


@pytest.fixture(scope="module")
def misaligned(granite):
    """The reference's 1-layer draft with its own weights.  Its stochastic
    proposals mostly miss; its greedy ones rarely do, since at this init a
    tied-embedding model's argmax is mostly its input token, the target's
    too."""
    return _pair("granite-8b", 1, 3)


@pytest.fixture(scope="module")
def untied(granite):
    """A 1-layer draft with its own head: its greedy proposals miss too, so
    greedy rounds roll back."""
    return _pair("granite-8b", 1, 3, tie_embeddings=False)


@pytest.fixture(scope="module")
def aligned(granite):
    """The target with layer 1's output projections zeroed (an exact
    residual identity) and its 1-layer prefix as draft: bitwise-equal logits,
    so the draft proposes exactly what the target samples."""
    model, params, tmodel, _ = granite
    tp = {"embed": params["embed"], "final_ln": params["final_ln"],
          "blocks": jax.tree_util.tree_map(lambda x: x, params["blocks"])}
    for mod, name in (("attn", "wo"), ("mlp", "wo")):
        w = np.asarray(tp["blocks"][mod][name]).copy()
        w[1:] = 0.0
        tp["blocks"][mod][name] = jnp.asarray(w)
    draft = build_model(dataclasses.replace(model.cfg, n_layers=1), model.rcfg)
    dp = {"embed": tp["embed"], "final_ln": tp["final_ln"],
          "blocks": jax.tree_util.tree_map(lambda x: x[:1], tp["blocks"])}
    tdraft = tbuild_model(dataclasses.replace(tmodel.cfg, n_layers=1), tmodel.rcfg,
                          device="cpu")
    return (model, tp, tmodel, _port(tp)), (draft, dp, tdraft, _port(dp))


@pytest.fixture(scope="module")
def recurrent():
    """{arch: (target, a misaligned 1-layer draft of key 3)} as jax/port
    pairs; zamba2's draft has its own head (see ``untied``)."""
    return {"rwkv6-1.6b": (_pair("rwkv6-1.6b", 2, 0), _pair("rwkv6-1.6b", 1, 3)),
            "zamba2-7b": (_pair("zamba2-7b", 2, 0),
                          _pair("zamba2-7b", 1, 3, tie_embeddings=False))}


def _prompts(vocab, sizes=(6, 3, 9, 1, 5), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


def _drive(eng, prompts, samplings=None, max_new=10):
    """Submit, run round by round to the end; (tokens in submit order,
    the reports of the rounds that ran)."""
    samplings = samplings or [None] * len(prompts)
    rids = [eng.submit(p, max_new=max_new, sampling=s) for p, s in zip(prompts, samplings)]
    reports = []
    while eng.active() or eng.scheduler.depth:
        reports.append(eng.step_paced())
    done = {r.rid: list(r.out_tokens) for r in eng.finished}
    return [done[r] for r in rids], reports


def _serve(eng, prompts, samplings, max_new=10):
    rids = [eng.submit(p, max_new=max_new, sampling=s) for p, s in zip(prompts, samplings)]
    eng.run_until_drained()
    done = {r.rid: list(r.out_tokens) for r in eng.finished}
    return [done[r] for r in rids]


def _spec_counters(eng) -> dict:
    snap = eng.metrics_snapshot()
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)
            if f.name.startswith("spec_") or f.name in ("preemptions", "resumes",
                                                          "prefill_dispatches", "steps")}


def _key_width(rows: int) -> int:
    """Bytes by which the port's key field outweighs the reference's."""
    ref = jax.random.key_data(jax.random.key(0))
    return rows * ref.shape[0] * (np.dtype(np.int64).itemsize - np.dtype(ref.dtype).itemsize)


def _hold_to_jax(target, draft, k, backend, prompts, max_new=10):
    """Both packages' SpecEngines on one greedy request set: tokens, every
    report field and the spec counters equal, the t2d frame wider by the
    key field.  Returns the port engine."""
    jm, jp, tm, tp = target
    jd, jdp, td, tdp = draft
    kw = dict(max_batch=4, max_len=MAX_LEN, spec_k=k)
    jcfg = JaxEngineConfig(**PAGED) if backend == "paged" else None
    tcfg = EngineConfig(**PAGED) if backend == "paged" else None
    jeng = JaxSpecEngine(jm, jp, jd, jdp, config=jcfg, **kw)
    want, jreps = _drive(jeng, prompts, max_new=max_new)
    eng = SpecEngine(tm, tp, td, tdp, config=tcfg, **kw)
    got, reps = _drive(eng, prompts, max_new=max_new)
    assert got == want
    assert len(reps) == len(jreps)
    for rep, jrep in zip(reps, jreps):
        a, b = dataclasses.asdict(rep), dataclasses.asdict(jrep)
        assert a.pop("t2d_frame_bytes") - b.pop("t2d_frame_bytes") == _key_width(rep.n_active)
        assert a == b
    assert _spec_counters(eng) == _spec_counters(jeng)
    assert eng.backend.name == backend
    return eng


# ---------------------------------------------------------------------------
# DecodeEngine conformance, construction checks
# ---------------------------------------------------------------------------

def test_decode_engine_conformance(granite, misaligned):
    _, _, tm, tp = granite
    _, _, td, tdp = misaligned
    eng = SpecEngine(tm, tp, td, tdp, max_batch=2, max_len=32)
    assert isinstance(eng, DecodeEngine)
    for attr in REQUIRED_ATTRS:
        assert hasattr(eng, attr), attr


def test_spec_engine_rejects_bad_setups(granite, misaligned, recurrent):
    _, _, tm, tp = granite
    _, _, td, tdp = misaligned
    eng = SpecEngine(tm, tp, td, tdp, max_batch=2, max_len=32)
    with pytest.raises(TypeError):
        eng.submit([1, 2, 3], pixel_values=np.zeros((1, 4)))
    with pytest.raises(ValueError, match="spec_k"):
        SpecEngine(tm, tp, td, tdp, max_batch=2, max_len=32, spec_k=0)
    other = tbuild_model(dataclasses.replace(td.cfg, vocab_size=256), td.rcfg, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpecEngine(tm, tp, other, tdp, max_batch=2, max_len=32)
    # dense lanes cannot un-write recurrent state
    (_, _, rm, _), _ = recurrent["rwkv6-1.6b"]
    lanes = DenseBackend(rm, 2, 32)
    with pytest.raises(RuntimeError):
        lanes.rollback(0, 1)


# ---------------------------------------------------------------------------
# greedy lanes against the JAX SpecEngine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("which", ["misaligned", "untied", "aligned"])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_greedy_matches_jax_spec_engine(granite, misaligned, untied, aligned, backend,
                                        which, k):
    """Tokens, reports, counters and frames equal the reference's; the
    aligned draft is accepted wholesale, the untied one is not; the paged
    pool (10 blocks of 4) preempts mid-stream and every block comes home."""
    drafts = {"misaligned": (granite, misaligned), "untied": (granite, untied),
              "aligned": aligned}
    target, draft = drafts[which]
    prompts = _prompts(granite[2].cfg.vocab_size)
    eng = _hold_to_jax(target, draft, k, backend, prompts)
    snap = eng.metrics_snapshot()
    assert snap.spec_rounds > 0
    if which == "aligned":
        assert snap.spec_acceptance_rate == 1.0
    if which == "untied":
        assert snap.spec_acceptance_rate < 1.0
    if backend == "paged":
        assert snap.preemptions > 0 and snap.resumes > 0
        assert eng.backend.blocks_in_use == 0


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_recurrent_greedy_matches_jax_spec_engine(recurrent, arch, k):
    """Recurrent target and draft: every round rolls back by replaying the
    kept prefix from the stash (zamba2's shared-block slots included)."""
    target, draft = recurrent[arch]
    prompts = _prompts(target[2].cfg.vocab_size, sizes=(6, 1, 4))
    eng = _hold_to_jax(target, draft, k, "recurrent", prompts)
    assert isinstance(eng.backend, RecurrentBackend)
    assert isinstance(eng.draft_backend, RecurrentBackend)
    assert eng.metrics_snapshot().spec_acceptance_rate < 1.0
    assert eng.backend.stash_bytes > 0


# ---------------------------------------------------------------------------
# stochastic lanes against the port's own ServeEngine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "paged", "aligned", "rwkv6-1.6b", "zamba2-7b"])
def test_stochastic_lanes_equal_the_serve_engine(granite, misaligned, aligned, recurrent,
                                                 case):
    if case in ("dense", "paged"):
        (_, _, tm, tp), (_, _, td, tdp) = granite, misaligned
    elif case == "aligned":
        (_, _, tm, tp), (_, _, td, tdp) = aligned
    else:
        (_, _, tm, tp), (_, _, td, tdp) = recurrent[case]
    config = EngineConfig(**PAGED) if case == "paged" else None
    prompts = _prompts(tm.cfg.vocab_size, sizes=(6, 5, 7, 4))
    samp = [None, STOCH, None, STOCH2]
    want = _serve(ServeEngine(tm, tp, 4, MAX_LEN, config=config), prompts, samp, 12)
    eng = SpecEngine(tm, tp, td, tdp, 4, MAX_LEN, spec_k=3, config=config)
    assert _serve(eng, prompts, samp, 12) == want
    snap = eng.metrics_snapshot()
    if case == "aligned":
        assert snap.spec_acceptance_rate == 1.0
        assert snap.spec_rounds * 2 <= snap.generated_tokens
    if case == "paged":
        assert snap.preemptions > 0 and eng.backend.blocks_in_use == 0


def test_stochastic_stream_per_seed_and_colocated(granite, misaligned):
    """For many seeds one stochastic request's stream equals the plain
    engine's; colocated pairs change no token and ship no frame."""
    _, _, tm, tp = granite
    _, _, td, tdp = misaligned
    prompt = _prompts(tm.cfg.vocab_size, sizes=(6,))[0]
    for seed in range(6):
        sp = [SamplingParams(temperature=8.0, top_k=64, seed=seed)]
        want = _serve(ServeEngine(tm, tp, 1, 32), [prompt], sp, 6)
        assert _serve(SpecEngine(tm, tp, td, tdp, 1, 32), [prompt], sp, 6) == want, seed
    prompts = _prompts(tm.cfg.vocab_size, sizes=(5, 2, 7))
    samp = [None, STOCH, None]
    a, _ = _drive(SpecEngine(tm, tp, td, tdp, 4, MAX_LEN, spec_k=2), prompts, samp)
    b, reps = _drive(SpecEngine(tm, tp, td, tdp, 4, MAX_LEN, spec_k=2, colocated=True),
                     prompts, samp)
    assert a == b
    assert all(r.d2t_frame_bytes == r.t2d_frame_bytes == 0 for r in reps)


def test_preempt_mid_stream_releases_the_draft_lane(granite, misaligned):
    _, _, tm, tp = granite
    _, _, td, tdp = misaligned
    prompts = _prompts(tm.cfg.vocab_size, sizes=(6, 3))
    samp = [STOCH, None]
    want = _serve(ServeEngine(tm, tp, 2, MAX_LEN), prompts, samp)
    eng = SpecEngine(tm, tp, td, tdp, 2, MAX_LEN)
    rids = [eng.submit(p, max_new=10, sampling=s) for p, s in zip(prompts, samp)]
    eng.step()
    eng.step()
    eng.preempt(0)
    assert not eng._draft_ready[0]
    eng.forget_lane(1)                   # a dead device: the request leaves
    assert not eng._draft_ready[1]
    eng.run_until_drained()
    done = {r.rid: list(r.out_tokens) for r in eng.finished}
    assert done == {rids[0]: want[0]}


# ---------------------------------------------------------------------------
# the window, the sampler
# ---------------------------------------------------------------------------

def _window_cases(granite, recurrent):
    yield "granite", granite
    for arch, (target, _) in recurrent.items():
        yield arch, target


@pytest.mark.parametrize("w", [1, 4])
def test_window_is_w_single_steps_and_matches_jax(granite, recurrent, w):
    """From one prefilled JAX cache: the port's window logits and cache are
    ``torch.equal`` to W of its single steps, and within 1e-4 x max(1,
    max|ref|) of the reference's ``lm_decode_window``."""
    rng = np.random.default_rng(w)
    for name, (jm, jp, tm, tp) in _window_cases(granite, recurrent):
        v = tm.cfg.vocab_size
        toks = rng.integers(0, v, size=(3, 7)).astype(np.int32)
        nxt = rng.integers(0, v, size=(3, w)).astype(np.int32)
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
        jl, _ = jlm.lm_decode_window(jm.cfg, jp, jc, jnp.asarray(nxt), jm.rcfg)
        host = jax.tree.map(np.asarray, jc)
        x = torch.as_tensor(nxt).long()
        with torch.no_grad():
            tl, tc = tm.decode_state.window_step(tp, cache_from_jax(host, device="cpu"), x)
            c = cache_from_jax(host, device="cpu")
            steps = []
            for j in range(w):
                lg, c = tm.decode_step(tp, c, x[:, j:j + 1])
                steps.append(lg)
        assert torch.equal(tl, torch.stack(steps, 1)), name
        for a, b in zip(jax.tree.leaves(tc, is_leaf=torch.is_tensor),
                        jax.tree.leaves(c, is_leaf=torch.is_tensor)):
            assert torch.equal(a, b), name
        ref = np.asarray(jl)
        err = np.abs(tl.numpy() - ref).max() / max(1.0, np.abs(ref).max())
        assert err < TOL, (name, err)


def test_pool_window_is_w_single_pool_steps(granite):
    _, _, tm, tp = granite
    ds = tm.decode_state
    rng = np.random.default_rng(0)
    tables = torch.as_tensor(np.arange(1, 13, dtype=np.int32).reshape(3, 4))
    x = torch.as_tensor(rng.integers(0, tm.cfg.vocab_size, size=(3, 5))).long()

    def pool():
        torch.manual_seed(0)
        c = ds.pool_init(3, 12, 4)
        for name in ("k", "v"):
            c["layers"][name].normal_()
        c["pos"].copy_(torch.tensor([3, 0, 9], dtype=torch.int32))
        return c
    with torch.no_grad():
        wl, wc = ds.pool_window_step(tp, pool(), x, tables)
        c, steps = pool(), []
        for j in range(x.shape[1]):
            lg, c = ds.pool_step(tp, c, x[:, j:j + 1], tables)
            steps.append(lg)
    assert torch.equal(wl, torch.stack(steps, 1))
    assert all(torch.equal(wc["layers"][n], c["layers"][n]) for n in ("k", "v"))
    assert torch.equal(wc["pos"], c["pos"])


def test_accept_matches_reference_on_greedy_lanes():
    """Coupled acceptance on one set of logits: emitted rows, counts and
    accepted counts equal the reference's, through misses, full accepts,
    the limit and eos."""
    rng = np.random.default_rng(5)
    b, w, v = 6, 4, 40
    logits = rng.standard_normal((b, w, v)).astype(np.float32)
    best = logits.argmax(-1)
    drafted = rng.integers(0, v, size=(b, w - 1)).astype(np.int32)
    drafted[1] = best[1, :-1]                    # the whole proposal accepted
    drafted[2, :2] = best[2, :2]                 # a miss at position 2
    drafted[3] = best[3, :-1]                    # accepted, but the limit cuts it
    drafted[4, 0] = best[4, 0]
    active = np.array([True, True, True, True, True, False])
    limit = np.array([5, 5, 5, 2, 5, 1])
    for eos in (None, int(best[4, 1])):
        want = JaxSampler(b).accept(logits, drafted, active, limit, eos_id=eos)
        got = Sampler(b).accept(torch.as_tensor(logits), drafted, active, limit, eos_id=eos)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert want[0][1] == list(best[1]) and len(want[0][3]) == 2 and want[0][5] == []


def test_masked_sample_freezes_the_key_and_copy_state():
    s = Sampler(3)
    for lane in range(3):
        s.set_lane(lane, SamplingParams(temperature=1.0, seed=lane))
    logits = torch.randn(3, 17, generator=torch.Generator().manual_seed(0))
    s.sample(logits, mask=np.array([True, False, True]))
    np.testing.assert_array_equal(s.lanes.key[:, 1], [1, 0, 1])
    d = Sampler(3)
    d.copy_state_from(s)
    for name in ("temperature", "top_k", "top_p", "key"):
        np.testing.assert_array_equal(getattr(d.lanes, name), getattr(s.lanes, name))
    assert d.lanes.key is not s.lanes.key
    assert np.array_equal(d.sample(logits), s.sample(logits))
