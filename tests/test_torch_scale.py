"""The port's scale plane (``serving/scale.py``, ``serving/traffic.py``,
``runtime/elastic.py``) against the reference, on the cases of
test_scale.py.

Every case runs twice, once on each package's modules, holds the
reference's own assertions on both runs, and asserts the two runs' results
exactly equal: traces array for array, ``ScaleSnapshot`` field by field
(NaN equal to NaN), autoscaler actions, SLO reports.  Nothing here imports
a model: the scale plane is model-free in both packages.
"""
import dataclasses
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _ns(pkg: str) -> SimpleNamespace:
    """The scale plane's names from one package."""
    import importlib
    mods = [importlib.import_module(f"{pkg}.{m}") for m in (
        "hw.specs", "runtime.elastic", "serving.metrics", "serving.scale",
        "serving.traffic")]
    ns = SimpleNamespace(pkg=pkg)
    for mod in mods:
        for name in dir(mod):
            if not name.startswith("__"):
                setattr(ns, name, getattr(mod, name))
    return ns


@pytest.fixture(scope="module")
def both():
    return [_ns(pkg) for pkg in PACKAGES]


def _uncompared() -> frozenset:
    """Names of the fields that the port's snapshots keep outside their
    equality (``compare=False``): ``EngineSnapshot.phases``, the host
    seconds of the engine's phases, which no two runs share and the
    reference does not keep."""
    from repro_torch.serving.metrics import EngineSnapshot
    return frozenset(f.name for f in dataclasses.fields(EngineSnapshot) if not f.compare)


UNCOMPARED = _uncompared()


def same(a, b) -> bool:
    """Exact structural equality across the two packages: dataclasses by
    class name and fields, arrays by dtype, shape and values, NaN == NaN.
    A field outside its dataclass's equality is not compared, nor its key
    in an ``as_dict()`` (``UNCOMPARED``)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__
                and all(same(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a) if f.compare))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, dict):
        keys = a.keys() - UNCOMPARED
        return isinstance(b, dict) and keys == b.keys() - UNCOMPARED and all(
            same(a[k], b[k]) for k in keys)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _on_both(both, scenario):
    """Run ``scenario(ns)`` on each package; the results must be equal."""
    ref, port = (scenario(ns) for ns in both)
    assert same(port, ref), (port, ref)
    return port


def _profile(m, decode=10.0, prefill=1e4, sustained=0.85, tau=60.0):
    return m.DeviceProfile(name="sim", year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                           link_bw=1e9, decode_steps_per_s=decode,
                           prefill_tokens_per_s=prefill, thermal_sustained=sustained,
                           thermal_tau_s=tau)


def _spec(m, **kw):
    prof_kw = {k: kw.pop(k) for k in ("decode", "prefill", "sustained", "tau") if k in kw}
    return m.ScaleWorkerSpec(profile=_profile(m, **prof_kw), **kw)


# ---------------------------------------------------------------------------
# traffic traces
# ---------------------------------------------------------------------------

def _trace_arrays(t):
    return (t.arrivals, t.prompt_lens, t.max_news, t.classes, t.kind, t.seed)


def test_traces_are_seed_deterministic(both):
    def scenario(m):
        out = []
        for make in (lambda s: m.poisson_trace(5.0, 20.0, seed=s),
                     lambda s: m.diurnal_trace(5.0, 20.0, period_s=20.0, seed=s),
                     lambda s: m.mmpp_trace(1.0, 20.0, 20.0, seed=s)):
            a, b = make(3), make(3)
            assert same(_trace_arrays(a), _trace_arrays(b))
            assert not np.array_equal(a.arrivals, make(4).arrivals)
            out.append(_trace_arrays(a))
        return out
    _on_both(both, scenario)


def test_merge_traces_interleaves_sorted(both):
    def scenario(m):
        a, b = m.poisson_trace(3.0, 10.0, seed=0), m.mmpp_trace(1.0, 10.0, 10.0, seed=1)
        merged = m.merge_traces(a, b)
        assert np.all(np.diff(merged.arrivals) >= 0)
        assert len(merged) == len(a) + len(b)
        return _trace_arrays(merged) + (merged.duration_s, merged.offered_rps,
                                        merged.offered_tokens)
    _on_both(both, scenario)


def test_sim_fleet_seeded_run_is_deterministic(both):
    def scenario(m):
        trace = m.merge_traces(
            m.diurnal_trace(20.0, 30.0, period_s=30.0, seed=2),
            m.mmpp_trace(0.0, 30.0, 30.0, calm_dwell_s=10.0, burst_dwell_s=2.0, seed=3))

        def run():
            fleet = m.SimFleet(
                m.make_rows(_spec(m, max_batch=4, max_queue=32), 24), n_start=6,
                tick_s=0.1, slo=(m.SLOClass("interactive", ttft_s=2.0),),
                autoscaler=m.AutoscalePolicy(min_workers=6, max_workers=24,
                                             target_wait_s=0.5, cooldown_s=1.0),
                autoscale_every_s=0.5, warm_param_bytes=1e8)
            m.play(fleet, trace)
            return fleet.snapshot()
        a = run()
        assert a == run()
        return a
    _on_both(both, scenario)


# ---------------------------------------------------------------------------
# loop-vs-vector oracle
# ---------------------------------------------------------------------------

def test_loop_and_vector_ticks_are_bit_identical(both):
    def scenario(m):
        def run(impl):
            fleet = m.SimFleet(
                m.make_rows(_spec(m, decode=4.0, sustained=0.5, tau=3.0, max_batch=2,
                                  max_queue=16), 8),
                n_start=3, tick_s=0.1, slo=(m.SLOClass("interactive", ttft_s=5.0),),
                autoscaler=m.AutoscalePolicy(min_workers=3, max_workers=8,
                                             target_wait_s=0.3, cooldown_s=0.5,
                                             settle_reads=2),
                autoscale_every_s=0.3, warm_param_bytes=2e8, impl=impl)
            rng = np.random.default_rng(0)
            sizes = list(zip(rng.integers(4, 40, 100), rng.integers(2, 30, 100)))
            for step in range(240):
                if step < 50:
                    for p, n in sizes[2 * step: 2 * step + 2]:
                        fleet.submit(int(p), int(n), deadline_s=6.0 if step % 3 else None)
                fleet.tick()
            return fleet.snapshot()
        a, b = run("vector"), run("loop")
        assert a.completed > 0
        assert a == b
        return a
    _on_both(both, scenario)


# ---------------------------------------------------------------------------
# admission shed vs capacity reject vs queued expiry
# ---------------------------------------------------------------------------

def test_capacity_reject_when_every_queue_is_full(both):
    def scenario(m):
        fleet = m.SimFleet([_spec(m, max_queue=4)], admission=False)
        rids = [fleet.submit(8, 4) for _ in range(10)]
        assert fleet.rejected == 6 and fleet.shed == 0
        assert fleet.offered == 10 and int(fleet.queue_len[0]) == 4
        return rids, fleet.snapshot()
    _on_both(both, scenario)


def test_admission_sheds_on_predicted_ttft_not_capacity(both):
    def scenario(m):
        fleet = m.SimFleet([_spec(m, prefill=100.0, max_queue=64)],
                           slo=(m.SLOClass("interactive", ttft_s=0.5),))
        assert fleet.submit(200, 4) is None
        assert fleet.shed == 1 and fleet.rejected == 0
        assert fleet.submit(10, 4) is not None
        snap = fleet.snapshot()
        assert snap.shed == 1 and snap.slo.shed == 1
        assert snap.slo.classes[0].shed == 1
        return snap
    _on_both(both, scenario)


def test_deadline_expiry_behind_drained_worker_at_depth(both):
    def scenario(m):
        fleet = m.SimFleet(
            [_spec(m, decode=1.0, prefill=1e6, sustained=0.5, tau=float("inf"),
                   max_batch=2, max_queue=128)],
            tick_s=0.05, admission=False)
        for _ in range(120):
            fleet.submit(4, 50, deadline_s=1.0)
        assert int(fleet.queue_len[0]) == 120
        fleet.heat[0] = 0.30
        for _ in range(60):
            fleet.tick()
        assert fleet.drains >= 1 and bool(fleet.drained[0])
        assert fleet.expired >= 100
        assert fleet.shed == 0 and fleet.rejected == 0
        snap = fleet.snapshot()
        assert snap.offered == (snap.completed + snap.shed + snap.rejected + snap.expired
                                + snap.queued_now + snap.active_now)
        return snap
    _on_both(both, scenario)


def test_books_balance_once_drained(both):
    def scenario(m):
        trace = m.poisson_trace(30.0, 10.0, seed=1, prompt_tokens=(4, 32),
                                max_new_tokens=(2, 12))
        fleet = m.SimFleet(m.make_rows(_spec(m, max_batch=4, max_queue=8), 4),
                           slo=(m.SLOClass("interactive", ttft_s=0.5),))
        elapsed = m.play(fleet, trace)
        snap = fleet.snapshot()
        assert snap.queued_now == 0 and snap.active_now == 0
        assert snap.offered == len(trace)
        assert snap.offered == snap.completed + snap.shed + snap.rejected + snap.expired
        return elapsed, snap, fleet.completed
    _on_both(both, scenario)


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

def test_autoscale_policy_bounds_and_hysteresis(both):
    def scenario(m):
        pol = m.AutoscalePolicy(min_workers=2, max_workers=6, target_wait_s=1.0,
                                idle_wait_s=0.2, step_frac=1.0, cooldown_s=5.0,
                                settle_reads=2)

        def load(t, *, serving, backlog, spare=10, util=0.0, depth=0):
            return m.FleetLoad(sim_t=t, serving=serving, warming=0, spare=spare,
                               queue_depth=depth, backlog_s=backlog, backlog_max_s=backlog,
                               hot_frac=0.0, util_mean=util)
        seen = []
        acts = pol.step(load(0.0, serving=2, backlog=9.0))
        assert [a.kind for a in acts] == ["scale_up"] and acts[0].detail["n"] == 2
        seen.append(acts)
        seen.append(pol.step(load(1.0, serving=4, backlog=9.0)))
        assert seen[-1] == []
        acts = pol.step(load(6.0, serving=4, backlog=9.0))
        assert acts[0].detail["n"] == 2
        seen.append(acts)
        seen.append(pol.step(load(12.0, serving=6, backlog=9.0)))
        seen.append(pol.step(load(20.0, serving=6, backlog=0.0)))
        assert seen[-2] == seen[-1] == []
        acts = pol.step(load(21.0, serving=6, backlog=0.0))
        assert [a.kind for a in acts] == ["scale_down"] and acts[0].detail["n"] == 4
        seen.append(acts)
        seen.append(pol.step(load(30.0, serving=2, backlog=9.0, spare=0)))
        assert seen[-1] == []
        return seen
    _on_both(both, scenario)


def test_fleet_scales_up_with_warm_delay_and_retires_down_to_min(both):
    def scenario(m):
        warm_bytes = 2.0 * _profile(m).link_bw
        fleet = m.SimFleet(
            m.make_rows(_spec(m, decode=2.0, max_batch=2, max_queue=64), 8),
            n_start=2, tick_s=0.1, admission=False,
            autoscaler=m.AutoscalePolicy(min_workers=2, max_workers=6, target_wait_s=0.1,
                                         idle_wait_s=0.05, step_frac=1.0, cooldown_s=0.0,
                                         settle_reads=2),
            autoscale_every_s=0.1, warm_param_bytes=warm_bytes)
        for _ in range(40):
            fleet.submit(4, 20)
        fleet.tick()
        assert fleet.scale_ups >= 1 and int(fleet.alive.sum()) > 2
        assert int(fleet._serving_mask().sum()) == 2
        assert fleet.warm_bytes_total == warm_bytes * (int(fleet.alive.sum()) - 2)
        for _ in range(25):
            fleet.tick()
        assert int(fleet._serving_mask().sum()) > 2
        for _ in range(2000):
            fleet.tick()
            if fleet.idle() and int(fleet._serving_mask().sum()) == 2:
                break
        snap = fleet.snapshot()
        assert snap.peak_serving <= 6
        assert snap.scale_downs >= 1 and snap.retired >= 1
        assert snap.serving_now == 2 and snap.completed == 40
        return snap
    _on_both(both, scenario)


# ---------------------------------------------------------------------------
# drivers: sim clocks never sleep
# ---------------------------------------------------------------------------

class _StubEngine:
    """Minimal drive_open_loop surface: clock/active/step/scheduler."""

    def __init__(self, clock):
        self.clock = clock
        self.scheduler = SimpleNamespace(depth=0)
        self.submitted = []

    def active(self) -> bool:
        return False

    def step(self) -> bool:
        return False


def test_drive_open_loop_sim_clock_advances_instead_of_sleeping(both, monkeypatch):
    def boom(_):
        raise AssertionError("slept under a simulated clock")
    monkeypatch.setattr(time, "sleep", boom)

    def scenario(m):
        eng = _StubEngine(m.SimClock())
        elapsed = m.drive_open_loop(eng, [0.0, 5.0, 9.0],
                                    lambda i, now: eng.submitted.append((i, now)))
        assert [i for i, _ in eng.submitted] == [0, 1, 2]
        assert elapsed >= 9.0
        return elapsed, eng.submitted
    _on_both(both, scenario)


def test_drive_open_loop_wall_clock_kw_is_gone(both):
    for m in both:
        with pytest.raises(TypeError, match="wall_clock"):
            m.drive_open_loop(_StubEngine(m.SimClock()), [0.0], lambda i, now: None,
                              wall_clock=False)


def test_drive_open_loop_rejects_sim_clock_without_advance(both):
    for m in both:
        with pytest.raises(TypeError, match="advance"):
            m.drive_open_loop(_StubEngine(lambda: 0.0), [0.0, 1.0], lambda i, now: None)


# ---------------------------------------------------------------------------
# SLO report math
# ---------------------------------------------------------------------------

def test_slo_report_folds_outcomes_per_class(both):
    def scenario(m):
        specs = (m.SLOClass("a", ttft_s=1.0, tpot_s=0.1), m.SLOClass("b"))
        report = m.slo_report(
            specs, class_ids=[0, 0, 0, 1], ttft_s=[0.5, 2.0, float("nan"), 0.2],
            tpot_s=[0.05, 0.05, float("nan"), float("nan")], tokens=[10, 10, 0, 5],
            outcome=[m.OUTCOME_DONE, m.OUTCOME_DONE, m.OUTCOME_SHED, m.OUTCOME_DONE],
            span_s=10.0)
        a, b = report.classes
        assert (a.offered, a.completed, a.shed) == (3, 2, 1)
        assert a.met == 1 and b.met == 1
        assert a.attainment == pytest.approx(1 / 3)
        assert a.served_attainment == pytest.approx(1 / 2)
        assert report.offered == 4 and report.met == 2
        assert report.attainment == pytest.approx(0.5)
        assert report.goodput_tokens_per_s == pytest.approx(1.5)
        assert report.tokens_per_s == pytest.approx(2.5)
        return report
    _on_both(both, scenario)
