"""The port's serving fleet (``serving/fleet.py``) against the reference, on
the cases of test_fleet.py, the ``StageGroup`` cases of
test_pipeline_decode.py and the ``SpecPair`` cases of test_speculative.py.

Every case runs once on each package (reduced granite, fp32, the same
weights through ``params_from_jax``), holds the reference's own assertions
on both runs, and compares the two runs' results with ``same``:
``FleetSnapshot.as_dict()`` field by field, routing, action logs, and the
tokens of greedy requests.  On the reference's mixed traffic a stochastic
lane draws other bits in each package (the port does not draw threefry
bits), so its tokens are held to the package's own unmigrated engine, as
the reference holds its own; its lengths, and so the whole sim schedule
and every snapshot field, still match.  The fields that cannot be
compared are named where a case drops them: the wall-time readings of
``telemetry="wall"``, and a spec pair's link seconds (``transfer_s``),
which follow its frame bytes: the port's target-to-draft frame carries
int64 ``(seed, counter)`` keys, 8 bytes a lane a round wider than the
reference's threefry key data, and the bytes are compared less that.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models.api import build_model as tbuild_model
from test_torch_scale import same

PACKAGES = ("repro", "repro_torch")
MODULES = ("hw.specs", "runtime.elastic", "runtime.faults", "runtime.monitor",
           "serving.engine", "serving.failover", "serving.fleet", "serving.sampling",
           "serving.scheduler", "serving.traffic")
MAX_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread for the module: the cases run tiny shapes,
    where more threads buy nothing, and under a parallel test run the
    workers' thread pools oversubscribe the cores (a file then takes about
    three times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, n_layers, key):
    """(jax model, jax params, port model, port params): one set of weights."""
    kw = {} if n_layers is None else dict(n_layers=n_layers)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), **kw)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                   compute_dtype="float32", remat=False),
                          device="cpu")
    params = model.init(jax.random.key(key))
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params),
                                                  device="cpu")


def _aligned(granite):
    """test_speculative.py's aligned target and draft: layer 1's output
    projections zeroed (an exact residual identity), its 1-layer prefix as
    draft.  (jax target, params, draft, params, port target, params, draft,
    params)."""
    model, params, tmodel, _ = granite
    tp = {"embed": params["embed"], "final_ln": params["final_ln"],
          "blocks": jax.tree_util.tree_map(lambda x: x, params["blocks"])}
    for mod, name in (("attn", "wo"), ("mlp", "wo")):
        w = np.asarray(tp["blocks"][mod][name]).copy()
        w[1:] = 0.0
        tp["blocks"][mod][name] = jnp.asarray(w)
    dp = {"embed": tp["embed"], "final_ln": tp["final_ln"],
          "blocks": jax.tree_util.tree_map(lambda x: x[:1], tp["blocks"])}
    draft = build_model(dataclasses.replace(model.cfg, n_layers=1), model.rcfg)
    tdraft = tbuild_model(dataclasses.replace(tmodel.cfg, n_layers=1), tmodel.rcfg,
                          device="cpu")

    def port(t):
        return params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
    return (model, tp, draft, dp), (tmodel, port(tp), tdraft, port(dp))


def make_both(models: dict):
    """One namespace a package: the fleet's modules' names, and each of
    ``models``' (model, params) pairs under its key, in that package."""
    out = []
    for i, pkg in enumerate(PACKAGES):
        ns = SimpleNamespace(pkg=pkg)
        for m in MODULES:
            mod = importlib.import_module(f"{pkg}.{m}")
            for name in dir(mod):
                if not name.startswith("__"):
                    setattr(ns, name, getattr(mod, name))
        for key, pair in models.items():
            setattr(ns, key, pair[2 * i:2 * i + 2])
        out.append(ns)
    return out


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-8b", 2, 0)


@pytest.fixture(scope="module")
def both(granite):
    lm4 = _pair("granite-8b", 4, 0)
    (jt, jtp, jd, jdp), (tt, ttp, td, tdp) = _aligned(granite)
    return make_both({"lm": granite, "lm4": lm4,
                      "target": (jt, jtp, tt, ttp), "draft": (jd, jdp, td, tdp)})


def on_both(both, scenario):
    """Run ``scenario(ns)`` on each package; the results must be equal."""
    ref, port = (scenario(m) for m in both)
    assert same(port, ref), (port, ref)
    return port


def greedy_tokens(fleet, samplings) -> dict:
    """rid -> tokens of the greedy requests (rid i had ``samplings[i]``)."""
    return {rec.req.rid: list(rec.req.out_tokens) for rec in fleet.completed
            if samplings[rec.req.rid] is None}


def _profile(m, name, rate=20.0, **kw):
    return m.DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=rate, prefill_tokens_per_s=1e9,
                           **kw)


def _fleet(m, *, rates=(20.0, 20.0), names=("a", "b"), max_batch=2, **kw):
    model, params = m.lm
    workers = [m.WorkerSpec(n, _profile(m, f"dev-{n}", r), max_batch=max_batch)
               for n, r in zip(names, rates)]
    return m.ServingFleet(model, params, workers, max_len=MAX_LEN, tick_s=0.05, **kw)


def _reference(m, model, params, prompts, samplings, max_new, max_len=MAX_LEN):
    ref = m.ServeEngine(model, params, max_batch=len(prompts), max_len=max_len)
    for p, sp in zip(prompts, samplings):
        ref.submit(p, max_new=max_new, sampling=sp)
    return {r.rid: list(r.out_tokens) for r in ref.run_until_drained()}


def _tokens(fleet) -> dict:
    return {rec.req.rid: list(rec.req.out_tokens) for rec in fleet.completed}


# ---------------------------------------------------------------------------
# policy and throttle units (no engines)
# ---------------------------------------------------------------------------

def test_serving_elastic_policy_edges_and_hysteresis(both):
    def scenario(m):
        mon = m.ThermalMonitor(alpha=1.0, calibration_steps=1, warmup_skip=0)
        pol = m.ServingElasticPolicy()
        seen = []
        for reading in (1.0, 1.10, None, 1.05, 1.0, 1.10):
            if reading is not None:
                mon.observe("w", reading)
            seen.append([a.kind for a in pol.step(mon)])
        assert seen[0] == [] and seen[1] == ["drain", "migrate", "duty_cycle"]
        assert seen[2] == ["duty_cycle"] and "undrain" not in seen[3]
        assert seen[4] == ["undrain"] and seen[5] == ["drain", "migrate", "duty_cycle"]
        return seen
    on_both(both, scenario)


def test_thermal_reservoir_heats_under_load_and_cools_idle(both):
    def scenario(m):
        res = m.ThermalReservoir({"hot": _profile(m, "hot", thermal_sustained=0.5,
                                                  thermal_tau_s=10.0)})
        hot = [res.advance("hot", 1.0, util=1.0) for _ in range(100)]
        cold = [res.advance("hot", 1.0, util=0.0) for _ in range(100)]
        assert hot[-1] > 1.8 and cold[-1] < 1.05
        assert res.advance("unknown", 1.0, 1.0) == 1.0
        return hot, cold, res.heat
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_fleet_routes_by_backlog_then_state(both):
    def scenario(m):
        fleet = _fleet(m)
        p = np.arange(6, dtype=np.int32)
        homes = [fleet.routed[fleet.submit(p, max_new=2)] for _ in range(2)]
        fleet.monitor.workers["b"] = m.WorkerStats(
            "b", baseline_s=1.0, ewma_s=1.2, state=m.ThermalState.SERIOUS)
        homes.append(fleet.routed[fleet.submit(p, max_new=2)])
        fleet.thermal_routing = False
        homes.append(fleet.routed[fleet.submit(p, max_new=2)])
        assert homes == ["a", "b", "a", "b"]
        return homes, fleet.snapshot().as_dict()
    on_both(both, scenario)


def test_fleet_drain_excludes_worker_until_undrained(both):
    def scenario(m):
        fleet = _fleet(m)
        p = np.arange(6, dtype=np.int32)
        fleet.drain("a")
        rids = [fleet.submit(p, max_new=2) for _ in range(3)]
        assert all(fleet.routed[r] == "b" for r in rids)
        fleet.undrain("a")
        assert fleet.routed[fleet.submit(p, max_new=2)] == "a"
        fleet.drain("a")
        fleet.drain("b")
        rid = fleet.submit(p, max_new=2)
        assert rid is not None and fleet.routed[rid] in ("a", "b")
        snap = fleet.snapshot()
        assert snap.drains == 3
        return fleet.routed, snap.as_dict()
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# migration / policies end to end
# ---------------------------------------------------------------------------

def _migration_traffic(m, greedy: bool):
    model, _ = m.lm
    prompts = [np.asarray(np.random.default_rng(10 + i).integers(
        0, model.cfg.vocab_size, size=6 + i), np.int32) for i in range(6)]
    samplings = [m.SamplingParams(temperature=3.0, top_k=16, seed=50 + i)
                 if i % 2 and not greedy else None for i in range(6)]
    return prompts, samplings


@pytest.mark.parametrize("traffic", ["mixed", "greedy"])
def test_fleet_migration_is_token_identical(both, traffic):
    """The reference's mixed traffic, and the same prompts all greedy: the
    port's tokens equal its own unmigrated engine's, greedy tokens and the
    whole snapshot equal the reference's."""
    def scenario(m):
        model, params = m.lm
        prompts, samplings = _migration_traffic(m, traffic == "greedy")
        fleet = _fleet(m, policy=m.ServingElasticPolicy(),
                       throttle=m.ThrottleTrace({"b": (0.2, 6.0, 0.1)}))
        m.drive_sim(fleet, np.linspace(0.0, 0.5, len(prompts)),
                    lambda i: fleet.submit(prompts[i], max_new=8, sampling=samplings[i]))
        snap = fleet.snapshot()
        assert snap.completed == len(prompts)
        assert snap.migrated_requests >= 1 and snap.drains >= 1
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings, 8)
        for rec in fleet.completed:
            if rec.migrated:
                assert rec.worker == "a"
        assert snap.per_worker["b"].state_occupancy.get("Critical", 0.0) > 0.0
        assert snap.goodput_tokens_per_s > 0.0
        return (greedy_tokens(fleet, samplings), snap.as_dict(),
                [(t, a.kind, a.worker) for t, a in fleet.action_log],
                sorted((rec.req.rid, rec.worker, rec.migrated, rec.sim_t)
                       for rec in fleet.completed))
    on_both(both, scenario)


def test_fleet_deadline_expires_queued_behind_drained_worker(both):
    def scenario(m):
        fleet = _fleet(m, rates=(20.0, 10.0), max_batch=1)
        long_p = np.arange(8, dtype=np.int32)
        r0 = fleet.submit(long_p, max_new=12)
        r1 = fleet.submit(long_p, max_new=12)
        assert fleet.routed[r0] == "a" and fleet.routed[r1] == "b"
        r2 = fleet.submit(np.arange(5, dtype=np.int32), max_new=2, deadline_s=1e-6)
        assert fleet.routed[r2] == "a"
        fleet.drain("a")
        fleet.run_until_drained(max_ticks=5_000)
        assert [r.rid for r in fleet.worker("a").engine.scheduler.expired] == [r2]
        snap = fleet.snapshot()
        assert snap.expired == 1 and snap.completed == 2
        assert {rec.req.rid for rec in fleet.completed} == {r0, r1}
        return _tokens(fleet), snap.as_dict()
    on_both(both, scenario)


def test_fleet_migration_skips_infeasible_destination(both):
    def scenario(m):
        model, params = m.lm
        tiny = m.EngineConfig(kv_blocks=4, kv_block_size=4)
        workers = [m.WorkerSpec("a", _profile(m, "da"), max_batch=2),
                   m.WorkerSpec("b", _profile(m, "db"), max_batch=2, engine_config=tiny)]
        fleet = m.ServingFleet(model, params, workers, max_len=MAX_LEN, tick_s=0.05)
        fleet.drain("b")
        p = np.arange(8, dtype=np.int32)
        rids = [fleet.submit(p, max_new=12) for _ in range(2)]
        for _ in range(2):
            fleet.tick()
        fleet.undrain("b")
        assert fleet.migrate("a") == 0
        fleet.run_until_drained(max_ticks=5_000)
        snap = fleet.snapshot()
        assert snap.migrations == 0 and snap.rejected == 0
        assert snap.per_worker["a"].engine.preemptions == 0
        assert {rec.req.rid for rec in fleet.completed} == set(rids)
        assert all(rec.worker == "a" for rec in fleet.completed)
        return _tokens(fleet), snap.as_dict()
    on_both(both, scenario)


def test_fleet_routing_respects_backend_feasibility(both):
    def scenario(m):
        model, params = m.lm
        tiny = m.EngineConfig(kv_blocks=4, kv_block_size=4)
        workers = [m.WorkerSpec("a", _profile(m, "da"), max_batch=2, engine_config=tiny),
                   m.WorkerSpec("b", _profile(m, "db"), max_batch=2)]
        fleet = m.ServingFleet(model, params, workers, max_len=MAX_LEN, tick_s=0.05)
        big, small = np.arange(8, dtype=np.int32), np.arange(4, dtype=np.int32)
        assert fleet.routed[fleet.submit(big, max_new=12)] == "b"
        assert fleet.routed[fleet.submit(small, max_new=2)] == "a"
        both_tiny = [m.WorkerSpec(n, _profile(m, f"d{n}"), max_batch=2, engine_config=tiny)
                     for n in ("a", "b")]
        fleet2 = m.ServingFleet(model, params, both_tiny, max_len=MAX_LEN, tick_s=0.05)
        assert fleet2.submit(big, max_new=12) is not None
        fleet2.run_until_drained(max_ticks=100)
        snap = fleet2.snapshot()
        assert snap.rejected == 1 and snap.completed == 0
        return fleet.routed, fleet2.routed, snap.as_dict()
    on_both(both, scenario)


def test_fleet_rejected_counts_once_across_probed_workers(both):
    def scenario(m):
        fleet = _fleet(m, scheduler=m.SchedulerConfig(policy="fcfs", max_queue=1))
        p = np.arange(6, dtype=np.int32)
        r0, r1 = fleet.submit(p, max_new=2), fleet.submit(p, max_new=2)
        assert fleet.routed[r0] == "a" and fleet.routed[r1] == "b"
        assert fleet.submit(p, max_new=2) is None
        snap = fleet.snapshot()
        assert snap.rejected == 1
        assert all(w.engine.scheduler.rejected_total == 0 and not w.engine.scheduler.rejected
                   for w in fleet.workers)
        return fleet.routed, snap.as_dict()
    on_both(both, scenario)


def test_fleet_migrate_queued_respects_destination_max_queue(both):
    def scenario(m):
        fleet = _fleet(m, scheduler=m.SchedulerConfig(policy="fcfs", max_queue=2))
        p = np.arange(6, dtype=np.int32)
        homes = [fleet.routed[fleet.submit(p, max_new=2)] for _ in range(4)]
        assert sorted(homes) == ["a", "a", "b", "b"]
        assert fleet.migrate("a") == 0
        assert fleet.worker("a").engine.scheduler.depth == 2
        assert fleet.worker("b").engine.scheduler.depth == 2
        snap = fleet.snapshot()
        assert snap.rejected == 0
        return homes, snap.as_dict()
    on_both(both, scenario)


def test_fleet_migrate_queued_midflight_counts_as_migrated(both):
    def scenario(m):
        fleet = _fleet(m)
        rid = fleet.submit(np.arange(6, dtype=np.int32), max_new=4)
        req = fleet.worker("a").engine.pull_queued()[0]
        req.admitted_t = 1.0
        req.out_tokens.append(3)
        fleet.worker("a").engine.inject(req, force=True)
        assert fleet.migrate("a") == 1
        snap = fleet.snapshot()
        assert snap.migrated_requests == 1 and snap.queue_moves == 1
        assert snap.migrations == 0
        fleet.run_until_drained(max_ticks=2_000)
        recs = {rec.req.rid: rec for rec in fleet.completed}
        assert recs[rid].migrated and recs[rid].worker == "b"
        return _tokens(fleet), snap.as_dict(), fleet.snapshot().as_dict()
    on_both(both, scenario)


def test_fleet_ignores_policy_actions_for_foreign_workers(both):
    def scenario(m):
        mon = m.ThermalMonitor(alpha=1.0, calibration_steps=1, warmup_skip=0)
        mon.workers["ghost"] = m.WorkerStats("ghost", baseline_s=1.0, ewma_s=1.5,
                                             state=m.ThermalState.CRITICAL)
        fleet = _fleet(m, monitor=mon, policy=m.ServingElasticPolicy())
        fleet.submit(np.arange(6, dtype=np.int32), max_new=2)
        for _ in range(3):
            fleet.tick()
        assert all(a.worker != "ghost" for _, a in fleet.action_log)
        snap = fleet.snapshot()
        assert snap.drains == 0
        return snap.as_dict()
    on_both(both, scenario)


def test_fleet_deadlines_run_on_the_sim_clock(both):
    def scenario(m):
        fleet = _fleet(m, names=("a",), rates=(20.0,), max_batch=1)
        eng = fleet.worker("a").engine
        assert eng._now() == fleet.sim_t
        r0 = fleet.submit(np.arange(8, dtype=np.int32), max_new=40)
        r1 = fleet.submit(np.arange(5, dtype=np.int32), max_new=2, deadline_s=0.2)
        r2 = fleet.submit(np.arange(5, dtype=np.int32), max_new=2, deadline_s=1e9)
        assert all(r.submitted_t == 0.0 for r in eng.queue)
        fleet.run_until_drained(max_ticks=5_000)
        assert [r.rid for r in eng.scheduler.expired] == [r1]
        assert {rec.req.rid for rec in fleet.completed} == {r0, r2}
        snap = fleet.snapshot()
        assert snap.expired == 1
        return _tokens(fleet), snap.as_dict()
    on_both(both, scenario)


def test_fleet_probes_drained_workers_at_paced_cost(both):
    def scenario(m):
        fleet = _fleet(m, probe_every_s=0.25)
        fleet.drain("b")
        for _ in range(4):
            fleet.submit(np.arange(6, dtype=np.int32), max_new=24)
        for _ in range(20):
            fleet.tick()
        snap = fleet.snapshot()
        a, b = snap.per_worker["a"], snap.per_worker["b"]
        assert a.probes == 0 and 0 < b.probes <= 1 + 20 * fleet.tick_s / 0.25
        assert fleet.monitor.workers["b"].steps == b.probes
        assert snap.probes == b.probes
        return snap.as_dict()
    on_both(both, scenario)


def test_fleet_wall_telemetry_never_mixes_time_scales(both):
    """Wall telemetry feeds MEASURED host times, which no two runs share:
    the monitor's EWMA and baseline, and the thermal states and actions
    they drive, are not compared across packages; what is compared is the
    structure the reference asserts (who was observed, how often)."""
    def scenario(m):
        fleet = _fleet(m, telemetry="wall", probe_every_s=0.05)
        fleet.drain("b")
        fleet.submit(np.arange(6, dtype=np.int32), max_new=4)
        fleet.run_until_drained(max_ticks=2_000)
        for _ in range(6):
            fleet.tick()
        assert "b" not in fleet.monitor.workers
        assert fleet.snapshot().per_worker["b"].probes == 0
        a = fleet.worker("a")
        ws = fleet.monitor.workers["a"]
        assert a.last_wall_step_s is not None
        before_gap = abs(ws.ewma_s - a.last_wall_step_s)
        n_before, p_before = ws.steps, a.probes
        for _ in range(8):
            fleet.tick()
        assert a.probes > p_before and ws.steps > n_before
        assert abs(ws.ewma_s - a.last_wall_step_s) <= before_gap + 1e-12
        return _tokens(fleet), a.probes - p_before, ws.steps - n_before, fleet.ticks
    on_both(both, scenario)


def test_fleet_migrate_picks_cheapest_victims_first(both):
    def scenario(m):
        fleet = _fleet(m, max_batch=2)
        fleet.drain("b")
        r_short = fleet.submit(np.arange(4, dtype=np.int32), max_new=24)
        r_long = fleet.submit(np.arange(20, dtype=np.int32), max_new=24)
        for _ in range(3):
            fleet.tick()
        assert fleet.worker("a").engine.active() == 2
        fleet.undrain("b")
        assert fleet.migrate("a", lanes=1) == 1
        assert fleet.snapshot().migrations == 1
        fleet.run_until_drained(max_ticks=5_000)
        recs = {rec.req.rid: rec for rec in fleet.completed}
        assert recs[r_short].worker == "b" and recs[r_short].migrated
        assert recs[r_long].worker == "a" and not recs[r_long].migrated
        return _tokens(fleet), fleet.snapshot().as_dict()
    on_both(both, scenario)


def test_fleet_duty_cycle_paces_steps(both):
    def scenario(m):
        class HalfDuty:
            def step(self, monitor):
                return [m.Action("duty_cycle", "a", {"duty": 0.5})]

        def steps_after(policy):
            fleet = _fleet(m, names=("a",), rates=(40.0,), policy=policy)
            for _ in range(8):
                fleet.submit(np.arange(6, dtype=np.int32), max_new=32)
            for _ in range(12):
                fleet.tick()
            return fleet.worker("a").steps_run, fleet.snapshot().as_dict()
        (full, s_full), (half, s_half) = steps_after(None), steps_after(HalfDuty())
        assert full > half >= 1 and half <= 0.7 * full
        return full, half, s_full, s_half
    on_both(both, scenario)


def test_fleet_seeded_trace_is_deterministic(both):
    def scenario(m):
        model, _ = m.lm
        trace = m.poisson_trace(4.0, 1.5, seed=5, prompt_tokens=(4, 10),
                                max_new_tokens=(2, 6))
        assert len(trace) > 0

        def run():
            fleet = _fleet(m)
            rng = np.random.default_rng(9)
            prompts = [rng.integers(0, model.cfg.vocab_size, size=int(p)).astype(np.int32)
                       for p in trace.prompt_lens]
            m.drive_sim(fleet, trace.arrivals,
                        lambda i: fleet.submit(prompts[i], max_new=int(trace.max_news[i])))
            return fleet.snapshot(), _tokens(fleet)
        first, again = run(), run()
        assert first == again
        return first[0].as_dict(), first[1]
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# stage groups (test_pipeline_decode.py's fleet cases, 4-layer granite)
# ---------------------------------------------------------------------------

def _group_profile(m, name, rate=20.0, link=1e6, mem=1e12):
    return m.DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=mem, mem_bw=1e9,
                           link_bw=link, decode_steps_per_s=rate, prefill_tokens_per_s=1e5)


def _group_traffic(m, n, seed):
    model, _ = m.lm4
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=6 + i) for i in range(n)]
    samplings = [m.SamplingParams(temperature=2.0, top_k=16, seed=700 + i) if i % 2 else None
                 for i in range(n)]
    return prompts, samplings


def _group_drive(m, fleet, prompts, samplings, arrivals, max_new=8):
    m.drive_sim(fleet, arrivals, lambda i: fleet.submit(prompts[i], max_new=max_new,
                                                        sampling=samplings[i]))


def test_fleet_stage_group_serves_and_charges_transfers(both):
    def scenario(m):
        model, params = m.lm4
        total = sum(int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(both[0].lm4[1]))
        grp = m.StageGroup("pair", (m.WorkerSpec("s0", _group_profile(m, "d0", mem=0.75 * total)),
                                    m.WorkerSpec("s1", _group_profile(m, "d1", mem=0.75 * total))),
                           max_batch=3)
        fleet = m.ServingFleet(model, params, groups=[grp], max_len=MAX_LEN, tick_s=0.05)
        prompts, samplings = _group_traffic(m, 6, 5)
        _group_drive(m, fleet, prompts, samplings, np.linspace(0.0, 0.5, 6))
        snap = fleet.snapshot()
        g = snap.per_group["pair"]
        assert snap.completed == g.completed == 6
        assert g.frames_sent > 0 and g.frame_bytes > 0 and g.transfer_s > 0.0
        assert snap.transfer_bytes == g.frame_bytes
        eng = fleet.group("pair").engine
        for sb, w in zip(eng.stage_param_bytes, grp.workers):
            assert sb <= w.profile.mem_bytes < total
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings, 8)
        return greedy_tokens(fleet, samplings), snap.as_dict(), list(eng.stage_param_bytes)
    on_both(both, scenario)


def test_fleet_narrow_link_slows_the_group(both):
    def scenario(m):
        model, params = m.lm4
        prompts, samplings = _group_traffic(m, 4, 7)

        def run(link):
            grp = m.StageGroup("pair", (m.WorkerSpec("s0", _group_profile(m, "d0", link=link)),
                                        m.WorkerSpec("s1", _group_profile(m, "d1", link=link))),
                               cuts=(2,), max_batch=4)
            fleet = m.ServingFleet(model, params, groups=[grp], max_len=MAX_LEN, tick_s=0.05)
            _group_drive(m, fleet, prompts, samplings, np.zeros(4))
            return fleet.snapshot()
        wide, narrow = run(1e9), run(2e4)
        assert wide.completed == narrow.completed == 4
        assert narrow.sim_t > wide.sim_t
        assert narrow.per_group["pair"].transfer_s > wide.per_group["pair"].transfer_s
        assert narrow.per_group["pair"].link_stall_ticks > 0
        assert narrow.goodput_tokens_per_s < wide.goodput_tokens_per_s
        return wide.as_dict(), narrow.as_dict()
    on_both(both, scenario)


@pytest.mark.parametrize("traffic", ["mixed", "greedy"])
def test_fleet_rebalance_recuts_split_token_identically(both, traffic):
    def scenario(m):
        model, params = m.lm4
        grp = m.StageGroup("pair", (m.WorkerSpec("s0", _group_profile(m, "d0")),
                                    m.WorkerSpec("s1", _group_profile(m, "d1"))),
                           cuts=(2,), max_batch=3)
        fleet = m.ServingFleet(model, params, groups=[grp], max_len=MAX_LEN, tick_s=0.05,
                               policy=m.ServingElasticPolicy(),
                               throttle=m.ThrottleTrace({"s1": (0.3, 6.0, 0.1)}))
        prompts, samplings = _group_traffic(m, 6, 9)
        if traffic == "greedy":
            samplings = [None] * 6
        _group_drive(m, fleet, prompts, samplings, np.linspace(0.0, 0.5, 6))
        snap = fleet.snapshot()
        g = snap.per_group["pair"]
        assert snap.completed == 6 and snap.recuts >= 1 and g.recuts >= 1
        assert g.cuts[0] > 2 and g.recut_bytes > 0
        assert any(a.kind == "rebalance" for _, a in fleet.action_log)
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings, 8)
        return (greedy_tokens(fleet, samplings), snap.as_dict(),
                [(t, a.kind, a.worker, a.detail) for t, a in fleet.action_log])
    on_both(both, scenario)


def test_fleet_group_routes_alongside_replica_worker(both):
    def scenario(m):
        model, params = m.lm4
        grp = m.StageGroup("pair", (m.WorkerSpec("s0", _group_profile(m, "d0")),
                                    m.WorkerSpec("s1", _group_profile(m, "d1"))),
                           cuts=(2,), max_batch=2)
        fleet = m.ServingFleet(model, params, [m.WorkerSpec("solo", _group_profile(m, "ds"))],
                               groups=[grp], max_len=MAX_LEN, tick_s=0.05)
        prompts, samplings = _group_traffic(m, 6, 11)
        _group_drive(m, fleet, prompts, samplings, np.linspace(0.0, 0.4, 6), max_new=6)
        assert set(fleet.routed.values()) == {"solo", "pair"}
        assert _tokens(fleet) == _reference(m, model, params, prompts, samplings, 6)
        return greedy_tokens(fleet, samplings), fleet.routed, fleet.snapshot().as_dict()
    on_both(both, scenario)


# ---------------------------------------------------------------------------
# speculative pairs (test_speculative.py's fleet cases)
# ---------------------------------------------------------------------------

def _spec_prompts(vocab, sizes):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).tolist() for n in sizes]


def _spec_pair(m, **kw):
    model, params = m.target
    draft, dparams = m.draft
    pair = m.SpecPair(name="pair", draft=m.WorkerSpec("d0", m.get_profile("a18-pro")),
                      target=m.WorkerSpec("t0", m.get_profile("m2-max-cpu")),
                      draft_model=draft, draft_params=dparams, spec_k=3)
    return m.ServingFleet(model, params, spec_pairs=[pair], max_len=MAX_LEN, **kw)


def _spec_dict(m, snap, lane_rounds: int) -> dict:
    """``as_dict()`` with the port's frames brought to the reference's
    width: its target-to-draft frame carries int64 ``(seed, counter)`` key
    pairs where the reference ships threefry key data, 8 bytes a lane a
    round wider, so the port's ``frame_bytes`` (and the fleet's
    ``transfer_bytes``) less 8 per lane-round must equal the reference's.
    The link seconds (``transfer_s``, the pair's and the fleet's) follow
    the bytes and are not compared; the wider frames stall no tick at these
    links, so the schedule and every other field still match."""
    d = snap.as_dict()
    for s in d["per_spec"].values():
        wider = 8 * lane_rounds if m.pkg == "repro_torch" else 0
        s["frame_bytes"] -= wider
        d["transfer_bytes"] -= wider
        s.pop("transfer_s")
    d.pop("transfer_s")
    return d


def _spec_run(m, colocated: bool):
    model, params = m.target
    sizes = (6, 3) if colocated else (6, 3, 9, 1)
    prompts = _spec_prompts(model.cfg.vocab_size, sizes)
    stoch = (m.SamplingParams(temperature=8.0, top_k=64, seed=11),
             m.SamplingParams(temperature=8.0, top_k=64, seed=99))
    samp = [None, stoch[0], None, stoch[1]][:len(sizes)]
    ref = m.ServeEngine(model, params, max_batch=4, max_len=MAX_LEN)
    want_rids = [ref.submit(p, max_new=10, sampling=s) for p, s in zip(prompts, samp)]
    ref.run_until_drained()
    want = {r.rid: list(r.out_tokens) for r in ref.finished}
    fleet = _spec_pair(m)
    eng = fleet.spec_pairs[0].engine
    if colocated:
        fleet.spec_pairs[0].set_colocated(True)
    lane_rounds = [0]                     # lanes a target-to-draft frame carried

    def counted(step=eng.step_paced):
        rep = step()
        lane_rounds[0] += rep.n_active if rep.t2d_frame_bytes else 0
        return rep
    eng.step_paced = counted
    rids = [fleet.submit(p, max_new=10, sampling=s) for p, s in zip(prompts, samp)]
    fleet.run_until_drained()
    done = {r.rid: list(r.out_tokens) for r in fleet.spec_pairs[0].engine.finished}
    assert [done[r] for r in rids] == [want[r] for r in want_rids]
    greedy = [done[r] for r, s in zip(rids, samp) if s is None]
    return fleet.snapshot(), greedy, lane_rounds[0]


def test_fleet_spec_pair_identity_and_frames(both):
    def scenario(m):
        snap, greedy, lane_rounds = _spec_run(m, colocated=False)
        ss = snap.per_spec["pair"]
        assert ss.engine.spec_rounds > 0 and ss.engine.spec_acceptance_rate == 1.0
        assert ss.frame_bytes > 0 and ss.spec_k == 3
        assert not ss.colocated and not ss.drained
        assert set(ss.members) == {"d0", "t0"} and ss.goodput_tokens_per_s > 0
        return greedy, _spec_dict(m, snap, lane_rounds), lane_rounds
    on_both(both, scenario)


def test_fleet_spec_pair_colocated_fallback(both):
    """Colocated, the pair ships no frames, so its snapshot compares whole."""
    def scenario(m):
        snap, greedy, lane_rounds = _spec_run(m, colocated=True)
        ss = snap.per_spec["pair"]
        assert ss.colocated and ss.colocations == 1 and ss.frame_bytes == 0
        assert lane_rounds == 0
        return greedy, snap.as_dict()
    on_both(both, scenario)
