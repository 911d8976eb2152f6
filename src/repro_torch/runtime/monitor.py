"""Thermal/straggler monitor (paper §4.2; a copy of ``repro/runtime/monitor.py``).

The paper watched Xcode's thermal states (Minimal -> Fair -> Serious) while
the iPhone's per-batch time crept from ~15.3 s to ~16.9 s.  Here the same
state machine runs on per-step latency telemetry: an EWMA per worker, state
thresholds expressed as slowdown ratios vs the worker's calibration
baseline, and a recommendation hook the elastic policies consume.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional


class ThermalState(enum.Enum):
    MINIMAL = "Minimal"
    FAIR = "Fair"
    SERIOUS = "Serious"
    CRITICAL = "Critical"


# slowdown-vs-baseline thresholds (paper Fig. 6: Fair ~batch 13 at ~1.02x,
# Serious ~batch 17 at ~1.05-1.10x, sustained)
THRESHOLDS = {
    ThermalState.MINIMAL: 1.00,
    ThermalState.FAIR: 1.02,
    ThermalState.SERIOUS: 1.08,
    ThermalState.CRITICAL: 1.25,
}


@dataclasses.dataclass
class WorkerStats:
    worker: str
    baseline_s: Optional[float] = None
    ewma_s: Optional[float] = None
    state: ThermalState = ThermalState.MINIMAL
    steps: int = 0
    state_history: List[ThermalState] = dataclasses.field(default_factory=list)

    @property
    def slowdown(self) -> float:
        if not self.baseline_s or not self.ewma_s:
            return 1.0
        return self.ewma_s / self.baseline_s


class ThermalMonitor:
    """EWMA latency tracking + paper-style thermal state machine."""

    def __init__(self, alpha: float = 0.25, calibration_steps: int = 3,
                 warmup_skip: int = 1):
        self.alpha = alpha
        self.calibration_steps = calibration_steps
        self.warmup_skip = warmup_skip       # drop compile-step outliers
        self.workers: Dict[str, WorkerStats] = {}

    def observe(self, worker: str, step_seconds: float) -> WorkerStats:
        ws = self.workers.setdefault(worker, WorkerStats(worker))
        ws.steps += 1
        if ws.steps <= self.warmup_skip:
            ws.state_history.append(ws.state)
            return ws
        if ws.ewma_s is None:
            ws.ewma_s = step_seconds
        else:
            ws.ewma_s = (1 - self.alpha) * ws.ewma_s + self.alpha * step_seconds
        if ws.steps == self.warmup_skip + self.calibration_steps:
            ws.baseline_s = ws.ewma_s
        ws.state = self._state_of(ws.slowdown)
        ws.state_history.append(ws.state)
        return ws

    @staticmethod
    def _state_of(slowdown: float) -> ThermalState:
        state = ThermalState.MINIMAL
        for st, thr in THRESHOLDS.items():
            if slowdown >= thr:
                state = st
        return state

    def stragglers(self, min_state: ThermalState = ThermalState.SERIOUS
                   ) -> List[WorkerStats]:
        order = list(ThermalState)
        return [w for w in self.workers.values()
                if order.index(w.state) >= order.index(min_state)]

    def occupancy(self) -> Dict[str, Dict[str, float]]:
        """Fraction of observations each worker spent in each thermal state
        (states never entered are omitted) — the fleet's per-worker
        thermal-state occupancy metric."""
        out: Dict[str, Dict[str, float]] = {}
        for w in self.workers.values():
            n = len(w.state_history)
            if not n:
                out[w.worker] = {}
                continue
            out[w.worker] = {
                s.value: w.state_history.count(s) / n
                for s in ThermalState if s in w.state_history}
        return out

    def summary(self) -> Dict[str, dict]:
        return {w.worker: {"state": w.state.value,
                           "slowdown": round(w.slowdown, 4),
                           "ewma_s": w.ewma_s}
                for w in self.workers.values()}
