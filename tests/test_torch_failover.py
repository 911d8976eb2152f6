"""The port's failure control plane (``runtime/faults.py``'s kill traces,
``serving/failover.py``, ``runtime/guard.py``, and ``SimFleet`` under kills)
against the reference, on the model-free cases of test_failover.py.

Every case runs on each package's modules, holds the reference's own
assertions on both runs, and asserts the results exactly equal (kill
traces, heartbeat verdicts, ``ScaleSnapshot`` field by field, the
determinism guard's verdicts and diffs).
"""
import dataclasses
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_scale import PACKAGES, _on_both


def _ns(pkg: str) -> SimpleNamespace:
    ns = SimpleNamespace(pkg=pkg)
    for m in ("hw.specs", "runtime.faults", "runtime.guard", "serving.failover",
              "serving.metrics", "serving.scale"):
        mod = importlib.import_module(f"{pkg}.{m}")
        for name in dir(mod):
            if not name.startswith("__"):
                setattr(ns, name, getattr(mod, name))
    return ns


@pytest.fixture(scope="module")
def both():
    return [_ns(pkg) for pkg in PACKAGES]


# ---------------------------------------------------------------------------
# fault schedule primitives
# ---------------------------------------------------------------------------

def test_fault_plan_check_is_nonmutating(both):
    def scenario(m):
        plan = m.FaultPlan(fail_at={3: "w1"})
        for _ in range(2):
            with pytest.raises(m.WorkerFailure) as ei:
                plan.check(3)
            assert (ei.value.worker, ei.value.step) == ("w1", 3)
        assert plan.fail_at == {3: "w1"}
        plan.check(2)
        return str(ei.value), plan
    _on_both(both, scenario)


def test_kill_event_validation_and_returns(both):
    def scenario(m):
        for bad in (dict(kind="meteor"), dict(kind="crash", down_s=0.0)):
            with pytest.raises(ValueError):
                m.KillEvent(t_s=1.0, worker="a", **bad)
        with pytest.raises(ValueError):
            m.KillEvent(t_s=-1.0, worker="a")
        events = (m.KillEvent(t_s=1.0, worker="a", kind="crash"),
                  m.KillEvent(t_s=1.0, worker="a", kind="partition", down_s=0.5),
                  m.KillEvent(t_s=1.0, worker="a", kind="zombie", down_s=math.inf))
        assert [e.returns for e in events] == [False, True, False]
        trace = m.KillTrace(events=tuple(reversed(events)))
        return [e.returns for e in events], trace, trace.deaths(), len(trace)
    _on_both(both, scenario)


def test_make_kill_trace_is_seeded_and_sorted(both):
    def scenario(m):
        workers = ["a", "b", "c", "d"]
        kinds = ("crash", "partition", "zombie")
        t1 = m.make_kill_trace(workers, 3, t0_s=0.5, t1_s=4.0, seed=11, kinds=kinds)
        t2 = m.make_kill_trace(workers, 3, t0_s=0.5, t1_s=4.0, seed=11, kinds=kinds)
        assert tuple(t1) == tuple(t2) and len(t1) == 3
        times = [e.t_s for e in t1]
        assert times == sorted(times) and all(0.5 <= t <= 4.0 for t in times)
        assert len({e.worker for e in t1}) == 3
        t3 = m.make_kill_trace(workers, 3, t0_s=0.5, t1_s=4.0, seed=12, kinds=kinds)
        assert tuple(t3) != tuple(t1)
        with pytest.raises(ValueError):
            m.make_kill_trace(["a"], 2)
        with pytest.raises(ValueError):
            m.make_kill_trace(workers, 1, kinds=("meteor",))

        def mk(seed):
            return [dataclasses.astuple(e) for e in m.make_kill_trace(workers, 2, seed=seed)]
        verdict = m.seeded_replay_check(mk, seed=5)
        return t1, t3, m.make_kill_trace(list(range(6)), 4, seed=2), verdict
    _on_both(both, scenario)


def test_heartbeat_monitor_thresholds(both):
    def scenario(m):
        cfg = m.FailoverConfig(suspect_after=2.0, dead_after=4.0)
        hb = m.HeartbeatMonitor(["a", "b"], probe_every_s=0.25, cfg=cfg)
        seen = [hb.state("a", 0.1), hb.state("a", 0.6), hb.state("a", 1.1)]
        assert seen == [m.ALIVE, m.SUSPECT, m.DEAD]
        hb.beat("a", 1.1)
        seen += [hb.state("a", 1.2), hb.state("b", 1.1), hb.gap("b", 1.1)]
        assert seen[3:5] == [m.ALIVE, m.DEAD]
        ckpt = m.LaneCheckpoint(rid=3, out_len=5, key=None, state=None, t_s=0.5)
        return seen, hb.last_seen, ckpt
    _on_both(both, scenario)


def test_failover_config_validation(both):
    for m in both:
        with pytest.raises(ValueError):
            m.FailoverConfig(suspect_after=4.0, dead_after=2.0)
        with pytest.raises(ValueError):
            m.FailoverConfig(checkpoint_every_s=0.0)
    _on_both(both, lambda m: m.FailoverConfig())


# ---------------------------------------------------------------------------
# SimFleet chaos
# ---------------------------------------------------------------------------

def _sim_profile(m, decode=10.0):
    return m.DeviceProfile(name="sim", year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=decode, prefill_tokens_per_s=1e4,
                           thermal_sustained=0.85, thermal_tau_s=60.0)


def _sim_fleet(m, trace=None, n=4, **kw):
    spec = m.ScaleWorkerSpec(profile=_sim_profile(m), max_batch=4, max_queue=32)
    kw.setdefault("tick_s", 0.05)
    kw.setdefault("admission", False)
    kw.setdefault("detect_s", 0.3)
    kw.setdefault("ckpt_every_s", 0.25)
    return m.SimFleet(m.make_rows(spec, n), kill_trace=trace, **kw)


def _sim_chaos_run(m, impl="vector", seed=0, n_kills=2, kinds=("crash",), **kw):
    trace = m.make_kill_trace(list(range(3)), n_kills, t0_s=0.3, t1_s=1.2, seed=seed,
                              kinds=kinds)
    fleet = _sim_fleet(m, trace, impl=impl, **kw)
    rng = np.random.default_rng(seed + 100)
    for _ in range(40):
        fleet.submit(int(rng.integers(4, 30)), int(rng.integers(4, 24)))
    while not fleet.idle() and fleet.ticks < 20000:
        fleet.tick()
    return fleet


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_crash_loses_nothing_and_bounds_recompute(both, seed):
    def scenario(m):
        fleet = _sim_chaos_run(m, seed=seed)
        snap = fleet.snapshot()
        assert not [r for r, st in enumerate(fleet.q_status) if st < 0]
        assert snap.completed == snap.offered == 40
        assert snap.deaths == 2 and snap.resurrections >= 1 and snap.orphaned == 0
        lanes = snap.deaths * 4
        assert 0 < snap.recompute_tokens <= lanes * (2 * 0.25 * 10.0 + 30 + 2)
        return snap, list(fleet.q_status)
    _on_both(both, scenario)


def test_sim_loop_and_vector_identical_under_kills(both):
    def scenario(m):
        kinds = ("crash", "zombie", "partition")
        a = _sim_chaos_run(m, impl="vector", kinds=kinds).snapshot()
        b = _sim_chaos_run(m, impl="loop", kinds=kinds).snapshot()
        assert a.deaths >= 1 and a == b
        return a
    _on_both(both, scenario)


def test_sim_partition_heal_before_detection_is_transparent(both):
    def scenario(m):
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.3, worker=0, kind="partition",
                                                down_s=0.1),))
        fleet = _sim_fleet(m, trace, detect_s=0.5)
        for _ in range(10):
            fleet.submit(10, 12)
        while not fleet.idle() and fleet.ticks < 20000:
            fleet.tick()
        snap = fleet.snapshot()
        assert snap.completed == 10
        assert snap.deaths == snap.resurrections == snap.recompute_tokens == 0
        kinds = [k for _, k, _ in snap.events]
        assert "kill" in kinds and "return" in kinds and "death" not in kinds
        return snap
    _on_both(both, scenario)


def test_sim_zombie_returns_cold_and_serves_again(both):
    def scenario(m):
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.2, worker=0, kind="zombie",
                                                down_s=0.5),))
        spec = m.ScaleWorkerSpec(profile=_sim_profile(m), max_batch=4, max_queue=32)
        fleet = m.SimFleet(m.make_rows(spec, 2), tick_s=0.05, admission=False,
                           kill_trace=trace, detect_s=0.1, ckpt_every_s=0.25,
                           warm_param_bytes=1e9)
        for _ in range(8):
            fleet.submit(10, 10)
        while fleet.sim_t < 0.75:
            fleet.tick()
        assert not fleet.dead[0] and fleet.warm_rem[0] > 0.0
        warm = float(fleet.warm_rem[0])
        while not fleet.idle() and fleet.ticks < 20000:
            fleet.tick()
        snap = fleet.snapshot()
        assert snap.completed == 8 and snap.deaths == 1
        return warm, snap
    _on_both(both, scenario)


def test_sim_dead_rows_are_not_spare_capacity(both):
    def scenario(m):
        trace = m.KillTrace(events=(m.KillEvent(t_s=0.2, worker=0, kind="crash"),))
        fleet = _sim_fleet(m, trace, n=4, detect_s=0.1)
        fleet.submit(10, 10)
        while fleet.sim_t < 0.5:
            fleet.tick()
        assert fleet.dead[0] and fleet.alive[0]
        load = fleet.load()
        assert load.spare == 0
        fleet._scale_up(4)
        assert fleet.dead[0] and not fleet._serving_mask()[0]
        assert not fleet.retiring[0]
        return load, fleet.snapshot()
    _on_both(both, scenario)


def test_sim_all_dead_blip_parks_then_recovers(both):
    def scenario(m):
        trace = m.KillTrace(events=tuple(
            m.KillEvent(t_s=0.3, worker=w, kind="partition", down_s=2.0) for w in range(2)))
        fleet = _sim_fleet(m, trace, n=2, detect_s=0.1)
        for _ in range(6):
            fleet.submit(10, 10)
        orphan_peak = 0
        while not fleet.idle() and fleet.ticks < 20000:
            fleet.tick()
            orphan_peak = max(orphan_peak, fleet.snapshot().orphaned)
        snap = fleet.snapshot()
        assert orphan_peak > 0
        assert snap.completed == 6 and snap.orphaned == 0
        assert all(st == m.OUTCOME_DONE for st in fleet.q_status)
        return orphan_peak, snap
    _on_both(both, scenario)


def test_sim_chaos_run_is_seed_deterministic(both):
    def scenario(m):
        def run(seed):
            return _sim_chaos_run(m, seed=seed, kinds=("crash", "zombie")).snapshot()
        return m.seeded_replay_check(run, seed=3), run(3)
    _on_both(both, scenario)


# ---------------------------------------------------------------------------
# the determinism guard's verdicts
# ---------------------------------------------------------------------------

def test_determinism_guard_verdicts_match(both):
    """A run that leaks state across calls diverges: both guards raise, and
    the non-strict verdicts and diffs are equal; ``diff_snapshots`` names
    the same paths on nested snapshots, arrays and NaNs."""
    def scenario(m):
        def leaky():
            calls = []

            def run(seed):
                calls.append(seed)
                return {"n": len(calls), "xs": np.arange(3) * len(calls),
                        "nan": float("nan"), "t": (seed, 1.0)}
            return run
        with pytest.raises(m.DeterminismError):
            m.seeded_replay_check(leaky(), seed=1)
        verdict = m.seeded_replay_check(leaky(), seed=1, runs=3, strict=False)
        assert not verdict[0]
        with pytest.raises(ValueError):
            m.seeded_replay_check(lambda s: s, runs=1)
        a = _sim_chaos_run(m, seed=0).snapshot()
        b = _sim_chaos_run(m, seed=1).snapshot()
        diffs = m.diff_snapshots(a, b)
        assert diffs and not m.diff_snapshots(a, a)
        return verdict, diffs, m.diff_snapshots({"a": [1, 2]}, {"a": [1, 2, 3]})
    _on_both(both, scenario)
