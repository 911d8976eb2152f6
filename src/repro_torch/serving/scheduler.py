"""Admission scheduling for the serving engine.

The engine asks the scheduler which queued requests to prefill whenever
decode lanes free up; the scheduler answers according to a pluggable policy
and enforces queue limits and per-request deadlines:

* ``fcfs``      — first come, first served (arrival order).
* ``spf``       — shortest-prompt-first: cheapest prefill next, which
  minimises mean TTFT under backlog (classic SJF argument).
* ``priority``  — higher ``Request.priority`` first; FCFS within a class.

``max_queue`` bounds the backlog (``submit`` is rejected beyond it — the
open-loop overload answer is admission control, not an unbounded queue), and
a request whose ``deadline_s`` elapses while still queued is dropped at pop
time rather than wasting prefill compute on an answer nobody is waiting for.

``pop`` is additionally FOOTPRINT-AWARE: a cache backend with a finite
capacity budget (the paged layout: free pool tokens, prefix-cache aware)
passes it with ``token_footprint``, and requests are packed against real
memory instead of popped blindly and bounced back; lane-bound backends
(dense, recurrent) pass no budget and get the plain take-k pop.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional

POLICIES = ("fcfs", "spf", "priority")
KEEP_DROPPED = 256          # recent rejected/expired kept for introspection


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "fcfs"
    max_queue: Optional[int] = None      # None = unbounded
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; expected one of {POLICIES}")


class AdmissionScheduler:
    """Holds the waiting queue; policy decides pop order, limits decide drops.

    Works on any request object exposing ``rid``, ``prompt`` (sized),
    ``priority``, ``submitted_t`` and optional ``deadline_s`` — i.e. the
    engine's Request.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._queue: List = []
        # bounded recency windows (totals are separate counters so a
        # long-lived overloaded engine doesn't hoard dropped Request objects)
        self.rejected = collections.deque(maxlen=KEEP_DROPPED)
        self.expired = collections.deque(maxlen=KEEP_DROPPED)
        self.rejected_total = 0
        self.expired_total = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._queue)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def push(self, req, now: float) -> bool:
        """Queue ``req``; False = rejected because the queue is full."""
        mq = self.config.max_queue
        if mq is not None and len(self._queue) >= mq:
            self.reject(req)
            return False
        if req.deadline_s is None:
            req.deadline_s = self.config.default_deadline_s
        self._queue.append(req)
        return True

    def requeue(self, req) -> None:
        """Return a previously popped request to the queue, bypassing
        ``max_queue`` — used for engine-side spills (KV blocks exhausted at
        admission) and preemptions, which must never be dropped.  The
        request keeps its original ``submitted_t``, so FCFS ranks it ahead
        of everything that arrived after it."""
        self._queue.append(req)

    def take_all(self) -> List:
        """Remove and return every queued request (no policy ordering) —
        the fleet re-routes a drained worker's backlog through it."""
        taken, self._queue = self._queue, []
        return taken

    def reject(self, req) -> None:
        """Record a request the engine can never run (admission control)."""
        self.rejected.append(req)
        self.rejected_total += 1

    def _drop_expired(self, now: float) -> None:
        live = []
        for r in self._queue:
            # deadlines bound QUEUE wait before first admission; a request
            # requeued mid-flight (preemption — admitted_t set) already has
            # tokens a client is owed and must never expire here
            started = getattr(r, "admitted_t", None) is not None
            if (not started and r.deadline_s is not None
                    and now - r.submitted_t > r.deadline_s):
                self.expired.append(r)
                self.expired_total += 1
            else:
                live.append(r)
        self._queue = live

    def _rank(self) -> Callable:
        # stable sort keyed per policy; arrival order breaks every tie
        if self.config.policy == "spf":
            return lambda r: (len(r.prompt), r.submitted_t, r.rid)
        if self.config.policy == "priority":
            return lambda r: (-r.priority, r.submitted_t, r.rid)
        return lambda r: (r.submitted_t, r.rid)

    def pop(self, k: int, now: float, footprint: Optional[Callable] = None,
            budget: Optional[int] = None,
            capacity: Optional[int] = None) -> List:
        """Take up to ``k`` requests to admit, best-first per policy.

        Footprint-aware admission: when the engine's cache backend exposes
        a capacity ``budget`` (e.g. free paged-KV tokens, prefix-cache
        aware), a request whose ``footprint(req)`` exceeds the remaining
        budget is SKIPPED — left queued, in order — and cheaper requests
        behind it may be packed instead of the whole pop stalling on one
        big prompt.  A request too big even for ``capacity`` (the whole
        pool) is still popped: the backend's ``alloc`` is the authority
        that rejects infeasible work up front, and hiding it in the queue
        forever would silently drop it."""
        if k <= 0:
            return []
        self._drop_expired(now)
        self._queue.sort(key=self._rank())
        if footprint is None or budget is None:
            taken, self._queue = self._queue[:k], self._queue[k:]
            return taken
        taken, kept = [], []
        remaining = budget
        for r in self._queue:
            if len(taken) >= k:
                kept.append(r)
                continue
            f = footprint(r)
            if f > remaining and (capacity is None or f <= capacity):
                kept.append(r)            # may fit later: keep waiting
                continue
            remaining -= f
            taken.append(r)
        self._queue = kept
        return taken

    def peek_order(self) -> List:
        """Current admission order (no side effects) — for introspection."""
        return sorted(self._queue, key=self._rank())

    def stats(self) -> Dict[str, int]:
        return {"depth": len(self._queue),
                "rejected": self.rejected_total,
                "expired": self.expired_total}
