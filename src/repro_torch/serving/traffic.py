"""Traffic plane: trace-driven arrival generators + open-loop driving
(a copy of ``repro/serving/traffic.py``, over the port's engine).

Open loop means arrivals never wait for the server — the standard way to
measure a serving system at a given offered load (benchmarks) or to demo
overload behaviour (examples).  Shared here so benches, examples and the
scale-plane simulator cannot drift apart on drive semantics.

Two halves:

* **Traces** — :class:`TrafficTrace` plus seeded generators for the arrival
  shapes production fleets actually see: stationary Poisson
  (:func:`poisson_trace`), diurnal load curves (:func:`diurnal_trace`, an
  inhomogeneous Poisson process sampled by thinning), bursty traffic
  (:func:`mmpp_trace`, a 2-state Markov-modulated Poisson process), and
  replayed logs (:func:`replay_trace`).  Everything is derived from a
  ``numpy`` Generator seeded explicitly, so the same seed yields the same
  trace bit-for-bit — fleet snapshots driven by a seeded trace are
  reproducible and can be asserted on in tests and CI.
* **Drivers** — :func:`drive_open_loop` submits a trace against a
  :class:`~repro_torch.serving.engine.ServeEngine`, pacing by the **engine's own
  clock**: wall-clock engines nap between arrivals, sim-paced engines jump
  their :class:`SimClock` forward and never sleep.  (The tick-paced
  scale-plane simulator has its own driver,
  :func:`repro_torch.serving.scale.play`.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ServeEngine


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """A deterministic arrival trace: per-request timing, sizing and class.

    Arrays are parallel, length ``n``; ``arrivals`` is seconds from trace
    start, sorted ascending.  ``classes`` indexes into whatever SLO-class
    table the consumer carries (see :class:`repro_torch.serving.metrics.SLOClass`).
    """
    arrivals: np.ndarray       # float64 (n,) seconds, ascending
    prompt_lens: np.ndarray    # int64 (n,) prompt tokens
    max_news: np.ndarray       # int64 (n,) output-token budgets
    classes: np.ndarray        # int64 (n,) SLO-class ids
    kind: str = "replay"
    seed: Optional[int] = None

    def __post_init__(self):
        n = len(self.arrivals)
        if not (len(self.prompt_lens) == len(self.max_news)
                == len(self.classes) == n):
            raise ValueError("trace arrays must be parallel")
        if n and np.any(np.diff(self.arrivals) < 0):
            raise ValueError("arrivals must be sorted ascending")

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def duration_s(self) -> float:
        return float(self.arrivals[-1]) if len(self) else 0.0

    @property
    def offered_rps(self) -> float:
        return len(self) / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def offered_tokens(self) -> int:
        return int(self.prompt_lens.sum() + self.max_news.sum())


def _sizes(rng: np.random.Generator, n: int, *,
           prompt_tokens=(8, 64), max_new_tokens=(8, 32),
           class_weights: Sequence[float] = (1.0,)):
    """Draw per-request sizes and SLO classes (uniform-int ranges, weighted
    class mix) from the trace's own rng stream."""
    plo, phi = prompt_tokens
    nlo, nhi = max_new_tokens
    prompts = rng.integers(plo, phi + 1, size=n, dtype=np.int64)
    max_news = rng.integers(nlo, nhi + 1, size=n, dtype=np.int64)
    w = np.asarray(class_weights, dtype=np.float64)
    classes = rng.choice(len(w), size=n, p=w / w.sum()).astype(np.int64)
    return prompts, max_news, classes


def poisson_trace(rate_rps: float, duration_s: float, *, seed: int = 0,
                  **size_kw) -> TrafficTrace:
    """Stationary Poisson arrivals at ``rate_rps`` for ``duration_s``."""
    rng = np.random.default_rng(seed)
    # exponential inter-arrivals, cumulated then truncated to the window
    n_max = max(16, int(rate_rps * duration_s * 2 + 64))
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-12), size=n_max)
    ts = np.cumsum(gaps)
    ts = ts[ts < duration_s]
    p, m, c = _sizes(rng, len(ts), **size_kw)
    return TrafficTrace(ts, p, m, c, kind="poisson", seed=seed)


def diurnal_trace(mean_rps: float, duration_s: float, *, period_s: float,
                  depth: float = 0.8, phase: float = -0.5 * np.pi,
                  seed: int = 0, **size_kw) -> TrafficTrace:
    """Diurnal load curve: inhomogeneous Poisson arrivals whose rate follows
    ``mean_rps * (1 + depth*sin(2*pi*t/period_s + phase))``, sampled exactly
    by thinning (Lewis & Shedler): draw candidates at the peak rate, keep
    each with probability ``rate(t)/peak``.  ``depth`` in [0, 1); the default
    phase starts the window at the trough so a bench sees a full ramp."""
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    rng = np.random.default_rng(seed)
    peak = mean_rps * (1.0 + depth)
    n_max = max(16, int(peak * duration_s * 2 + 64))
    ts = np.cumsum(rng.exponential(1.0 / max(peak, 1e-12), size=n_max))
    ts = ts[ts < duration_s]
    rate = mean_rps * (1.0 + depth * np.sin(2 * np.pi * ts / period_s + phase))
    keep = rng.random(len(ts)) < rate / peak
    ts = ts[keep]
    p, m, c = _sizes(rng, len(ts), **size_kw)
    return TrafficTrace(ts, p, m, c, kind="diurnal", seed=seed)


def mmpp_trace(calm_rps: float, burst_rps: float, duration_s: float, *,
               calm_dwell_s: float = 30.0, burst_dwell_s: float = 5.0,
               seed: int = 0, **size_kw) -> TrafficTrace:
    """Bursty traffic: a 2-state Markov-modulated Poisson process.  The
    modulating chain dwells exponentially in a calm state (``calm_rps``)
    and a burst state (``burst_rps``); arrivals within each dwell are
    Poisson at that state's rate."""
    rng = np.random.default_rng(seed)
    ts_parts = []
    t, bursting = 0.0, False
    while t < duration_s:
        dwell = rng.exponential(burst_dwell_s if bursting else calm_dwell_s)
        end = min(t + dwell, duration_s)
        rate = burst_rps if bursting else calm_rps
        if rate > 0:
            n_max = max(4, int(rate * (end - t) * 2 + 16))
            seg = t + np.cumsum(rng.exponential(1.0 / rate, size=n_max))
            ts_parts.append(seg[seg < end])
        t, bursting = end, not bursting
    ts = (np.concatenate(ts_parts) if ts_parts
          else np.empty(0, dtype=np.float64))
    p, m, c = _sizes(rng, len(ts), **size_kw)
    return TrafficTrace(ts, p, m, c, kind="mmpp", seed=seed)


def replay_trace(arrivals: Sequence[float],
                 prompt_lens: Sequence[int],
                 max_news: Sequence[int],
                 classes: Optional[Sequence[int]] = None) -> TrafficTrace:
    """Wrap a recorded log (e.g. parsed production timestamps) as a trace."""
    a = np.asarray(arrivals, dtype=np.float64)
    order = np.argsort(a, kind="stable")
    c = (np.asarray(classes, dtype=np.int64) if classes is not None
         else np.zeros(len(a), dtype=np.int64))
    return TrafficTrace(a[order],
                        np.asarray(prompt_lens, dtype=np.int64)[order],
                        np.asarray(max_news, dtype=np.int64)[order],
                        c[order], kind="replay")


def merge_traces(*traces: TrafficTrace) -> TrafficTrace:
    """Superpose traces (e.g. a diurnal base + an MMPP burst overlay) into
    one time-sorted trace; class ids are preserved as-is."""
    if not traces:
        raise ValueError("need at least one trace")
    a = np.concatenate([t.arrivals for t in traces])
    order = np.argsort(a, kind="stable")
    return TrafficTrace(
        a[order],
        np.concatenate([t.prompt_lens for t in traces])[order],
        np.concatenate([t.max_news for t in traces])[order],
        np.concatenate([t.classes for t in traces])[order],
        kind="+".join(t.kind for t in traces))


# ---------------------------------------------------------------------------
# clocks + drivers
# ---------------------------------------------------------------------------
class SimClock:
    """A callable clock the driver can jump forward: pass as
    ``ServeEngine(..., clock=SimClock())`` and :func:`drive_open_loop`
    advances simulated time instead of sleeping wall time."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("cannot advance a clock backwards")
        self.t += dt


def drive_open_loop(engine: ServeEngine, arrival_times: Sequence[float],
                    submit: Callable[[int, float], None], *,
                    max_sleep_s: float = 0.01) -> float:
    """Run ``engine`` until every arrival is submitted and drained.

    ``arrival_times`` are seconds from start, sorted ascending;
    ``submit(i, now)`` is called when arrival ``i`` comes due (it decides
    prompt/params and calls ``engine.submit``).  Between due arrivals the
    engine decodes.

    Pacing follows the **engine's clock** (``engine.clock``): under the
    default wall clock an idle engine naps until the next arrival (bounded
    by ``max_sleep_s`` so admission stays responsive); under a sim-paced
    clock the driver jumps time forward to the next arrival and never
    sleeps — a sim-paced drive costs compute time only, regardless of the
    trace's simulated span.  Sim clocks must expose ``advance(dt)``
    (see :class:`SimClock`).  Returns elapsed seconds on the pacing clock.

    There is no ``wall_clock=`` kwarg: pacing is always ``engine.clock``,
    so a sim-paced drive never sleeps.
    """
    clock: Callable[[], float] = engine.clock
    simulated = clock is not time.perf_counter
    t0 = clock()
    n, nxt = len(arrival_times), 0
    while nxt < n or engine.active() or engine.scheduler.depth:
        now = clock() - t0
        while nxt < n and arrival_times[nxt] <= now:
            submit(nxt, now)
            nxt += 1
        if not engine.step() and nxt < n:
            wait = arrival_times[nxt] - (clock() - t0)
            if wait <= 0:
                continue
            if simulated:
                advance = getattr(clock, "advance", None)
                if advance is None:
                    raise TypeError(
                        "engine.clock is sim-paced but has no advance(); "
                        "use repro_torch.serving.traffic.SimClock (or drive a "
                        "tick-paced SimFleet with repro_torch.serving.scale.play)")
                advance(wait)
            else:
                # the ONE legitimate nap: a wall-clock engine idling until
                # its next arrival really does wait in real time
                time.sleep(min(wait, max_sleep_s))  # repro-lint: allow[R002] wall-clock engines nap for real; sim clocks take the advance() branch above
    return clock() - t0


def drive_trace(engine: ServeEngine, trace: TrafficTrace,
                submit: Callable[[int, float], None], *,
                max_sleep_s: float = 0.01) -> float:
    """Drive a :class:`TrafficTrace` open-loop: thin sugar over
    :func:`drive_open_loop` for callers that already hold a trace."""
    return drive_open_loop(engine, trace.arrivals, submit,
                           max_sleep_s=max_sleep_s)
