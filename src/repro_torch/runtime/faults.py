"""Fault and throttle injection (a copy of ``repro/runtime/faults.py``).

Faults are injected from seeded plans:

* :class:`FaultPlan` -- the training face: step-indexed worker failures
  (raised as :class:`WorkerFailure` for the trainer to catch) and
  per-worker thermal throttle ramps.  ``check`` is non-mutating, so a
  replayed run sees the same failures every time; surviving a failure is
  recorded by the trainer, never by editing the plan.
* :class:`KillTrace` -- the serving face: a seeded, time-indexed schedule
  of worker deaths for the failure plane (:mod:`repro_torch.serving.failover`,
  the scale plane's ``SimFleet``).  Three kinds model the paper's phone
  pathologies: ``"crash"`` (battery death: gone for good), ``"partition"``
  (network drop or backgrounding: the worker keeps its memory and returns
  after ``down_s``) and ``"zombie"`` (thermal shutdown then reboot: it
  returns after ``down_s``, cold).

:func:`make_kill_trace` draws a trace from a seeded
``numpy.random.Generator``: the same seed yields the same deaths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Sequence, Tuple, Union

import numpy as np

KILL_KINDS = ("crash", "partition", "zombie")


class WorkerFailure(RuntimeError):
    def __init__(self, worker: str, step: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.worker = worker
        self.step = step


@dataclasses.dataclass
class FaultPlan:
    """fail_at: step -> worker ; throttle: worker -> (start_step, factor, tau)"""
    fail_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    throttle: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def check(self, step: int) -> None:
        """Raise :class:`WorkerFailure` if a failure is planned at ``step``
        (non-mutating: checking the same step twice raises twice)."""
        worker = self.fail_at.get(step)
        if worker is not None:
            raise WorkerFailure(worker, step)

    def slowdown(self, worker: str, step: int) -> float:
        """Thermal-curve multiplier (paper Fig. 6 shape: ramp to plateau)."""
        if worker not in self.throttle:
            return 1.0
        start, factor, tau = self.throttle[worker]
        if step < start:
            return 1.0
        ramp = 1.0 - math.exp(-(step - start) / max(tau, 1e-9))
        return 1.0 + (factor - 1.0) * ramp


# ---------------------------------------------------------------------------
# serving-plane kill traces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KillEvent:
    """One scheduled worker death.

    ``worker`` is a fleet worker/member name (str) or a SimFleet row index
    (int).  ``down_s`` only applies to ``partition`` / ``zombie`` — how
    long the worker stays unreachable before returning (``inf`` = never,
    which a ``crash`` always is)."""
    t_s: float
    worker: Union[str, int]
    kind: str = "crash"
    down_s: float = math.inf

    def __post_init__(self) -> None:
        if self.kind not in KILL_KINDS:
            raise ValueError(f"kill kind {self.kind!r} not in {KILL_KINDS}")
        if self.t_s < 0 or self.down_s <= 0:
            raise ValueError(f"kill event needs t_s >= 0 and down_s > 0, "
                             f"got t_s={self.t_s}, down_s={self.down_s}")

    @property
    def returns(self) -> bool:
        return self.kind != "crash" and math.isfinite(self.down_s)


@dataclasses.dataclass(frozen=True)
class KillTrace:
    """A time-ordered schedule of :class:`KillEvent`; iterable, indexable,
    and safe to share between a fleet and its reference run (frozen)."""
    events: Tuple[KillEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: (e.t_s, str(e.worker)))))

    def __iter__(self) -> Iterator[KillEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def deaths(self) -> int:
        """Events that remove a worker for good (crashes plus kills that
        never return)."""
        return sum(1 for e in self.events if not e.returns)


def make_kill_trace(workers: Sequence[Union[str, int]], n_kills: int, *,
                    t0_s: float = 0.0, t1_s: float = 10.0, seed: int = 0,
                    kinds: Sequence[str] = ("crash",),
                    down_s: Tuple[float, float] = (0.5, 2.0)) -> KillTrace:
    """Draw a seeded kill trace: ``n_kills`` distinct workers die at
    uniform times in ``[t0_s, t1_s)`` with kinds cycled from ``kinds``
    (deterministically shuffled), partition/zombie outages lasting uniform
    ``down_s`` seconds.  Same seed, same trace — the chaos harness's whole
    input is (workers, seed)."""
    if n_kills > len(workers):
        raise ValueError(f"cannot kill {n_kills} of {len(workers)} workers "
                         "(each worker dies at most once per trace)")
    for k in kinds:
        if k not in KILL_KINDS:
            raise ValueError(f"kill kind {k!r} not in {KILL_KINDS}")
    rng = np.random.default_rng(seed)
    victims = [workers[i] for i in rng.permutation(len(workers))[:n_kills]]
    times = sorted(float(t) for t in rng.uniform(t0_s, t1_s, size=n_kills))
    events = []
    for t, w in zip(times, victims):
        kind = kinds[int(rng.integers(len(kinds)))]
        dur = math.inf if kind == "crash" \
            else float(rng.uniform(down_s[0], down_s[1]))
        events.append(KillEvent(t_s=t, worker=w, kind=kind, down_s=dur))
    return KillTrace(tuple(events))
