"""Fault and throttle injection for the training loop (port of the
training face of ``repro/runtime/faults.py``: ``FaultPlan``,
``WorkerFailure``; the serving-plane kill traces wait for the fleet,
ROADMAP §1 item 6).

Faults are injected from plans: :class:`FaultPlan` holds step-indexed
worker failures (raised as :class:`WorkerFailure` for the trainer to catch)
and per-worker thermal throttle ramps.  ``check`` is non-mutating, so a
replayed run sees the same failures every time; surviving a failure is
recorded by the trainer, never by editing the plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


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
