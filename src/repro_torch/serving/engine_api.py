"""The DecodeEngine protocol: the engine surface the fleet actually uses.

`ServingFleet`, `drive_sim` and the benches historically duck-typed
against :class:`~repro_torch.serving.engine.ServeEngine`; with three engine
implementations (plain, pipeline-split, speculative) the contract is now
explicit.  An engine is anything that:

* takes work — ``submit`` (client entry, decode policy via
  ``SamplingParams``), ``inject`` (fleet routing / migration),
  ``pull_queued`` (backlog re-routing), ``feasible`` (admission
  pre-check for migration);
* advances — ``step`` (admit + one decode round; returns #active lanes)
  and the convenience ``run_until_drained``;
* yields lanes back — ``preempt`` (token-identical eviction, optionally
  returning the Request for migration) and ``lane_cost`` (victim
  ordering for cost-aware migration);
* reports — ``active``, ``metrics_snapshot`` / ``reset_stats``.

The protocol is methods-only (``@runtime_checkable`` ``isinstance``
checks look at methods, not attributes); the data attributes every
engine must also carry — the fleet reads them directly — are listed in
:data:`REQUIRED_ATTRS` and asserted by the conformance test.
"""

from __future__ import annotations

from typing import Any, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np

from repro_torch.serving.metrics import EngineSnapshot
from repro_torch.serving.sampling import SamplingParams

# data attributes the fleet reads off an engine besides the methods below
# (checked by hasattr in the conformance test; Protocols can't require
# instance attributes under runtime_checkable)
REQUIRED_ATTRS = ("scheduler", "slots", "finished", "max_batch", "metrics")


@runtime_checkable
class DecodeEngine(Protocol):
    """Structural type of every serving engine (plain / pipeline / spec)."""

    def submit(self, prompt: np.ndarray, max_new: int = ...,
               sampling: Optional[SamplingParams] = ..., priority: int = ...,
               deadline_s: Optional[float] = ..., **extra) -> Optional[int]:
        ...

    def inject(self, req, *, force: bool = ...) -> bool:
        ...

    def pull_queued(self) -> List:
        ...

    def feasible(self, req) -> bool:
        ...

    def preempt(self, slot: int, requeue: bool = ...):
        ...

    def forget_lane(self, slot: int):
        ...

    def lane_cost(self, slot: int) -> Tuple[int, int]:
        ...

    def active(self) -> int:
        ...

    def step(self) -> Any:
        ...

    def run_until_drained(self, max_steps: int = ...) -> List:
        ...

    def reset_stats(self) -> None:
        ...

    def metrics_snapshot(self) -> EngineSnapshot:
        ...
