"""Failure plane for the serving fleet: heartbeats + lane checkpoints
(a copy of ``repro/serving/failover.py``).

The paper's phones are the least reliable workers imaginable — battery
death, thermal shutdown, iOS backgrounding — yet until this module the
fleet only modelled *throttling*, never *disappearance*.  Two pieces make
a worker's death survivable:

* :class:`HeartbeatMonitor` — missed-probe detection layered on the
  fleet's existing paced telemetry.  Every decode step or paced probe a
  member executes IS its heartbeat (``ServingFleet._observe_or_probe``
  feeds :meth:`beat`); liveness costs nothing extra, exactly as on a real
  fleet where "the worker answered" is the signal.  A member whose last
  beat is older than ``suspect_after`` probe intervals is SUSPECT (routed
  around, lanes untouched); older than ``dead_after`` intervals is DEAD
  (its unit's lanes are resurrected elsewhere).  Thresholds are in
  multiples of the fleet's ``probe_every_s`` so tightening the probe
  cadence tightens detection with it.

* :class:`LaneCheckpoint` — the resurrection state: every
  ``checkpoint_every_s`` sim seconds the fleet snapshots each active
  lane's generated-token count, its frozen sampler PRNG counter, and
  whatever the backend can save cheaply (``CacheBackend.snapshot`` —
  free constant-size state for recurrent backends, ``None`` for
  dense/paged whose KV dies with the device).  A dead worker's request
  is rolled back to its checkpoint and re-admitted on a survivor through
  the same preempt/inject machinery migration uses, so the resume is
  **token-identical**: recurrent lanes restore state outright; paged and
  dense lanes re-prefill — through the destination's refcounted prefix
  cache when the content is there — with recompute bounded by
  tokens-since-checkpoint plus one context re-prefill.

Pure control-plane code: no tensors, no wall clock, no global RNG, so
the model-free scale plane can import it too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class FailoverConfig:
    """Failure-plane knobs.

    ``suspect_after`` / ``dead_after`` are in units of the fleet's
    ``probe_every_s`` (a healthy member beats at least once per probe
    interval, so "2 missed intervals" is meaningful at any cadence);
    ``checkpoint_every_s`` is in sim seconds and bounds resurrection
    recompute: a resurrected lane replays at most
    ``checkpoint_every_s * decode_rate`` generated tokens plus one
    context re-prefill."""
    checkpoint_every_s: float = 0.5
    suspect_after: float = 2.0       # missed probe intervals -> SUSPECT
    dead_after: float = 4.0          # missed probe intervals -> DEAD

    def __post_init__(self) -> None:
        if self.dead_after <= self.suspect_after:
            raise ValueError(
                f"dead_after ({self.dead_after}) must exceed suspect_after "
                f"({self.suspect_after}): a worker can't be dead before "
                "it's suspect")
        if self.checkpoint_every_s <= 0:
            raise ValueError("checkpoint_every_s must be positive")


@dataclasses.dataclass(frozen=True)
class LaneCheckpoint:
    """Resurrection state of one active lane at checkpoint time.

    ``key`` is a copy of the lane's sampler PRNG counter (the stream
    resumes exactly where the checkpoint left it); ``state`` is the
    backend snapshot (recurrent: host-side state, zero-recompute resume)
    or ``None`` (dense/paged: resume re-prefills context).  Host-side
    control-plane data only — nothing here lives on the dead device."""
    rid: int
    out_len: int                     # generated tokens at checkpoint
    key: Optional[Any]               # sampler PRNG counter copy
    state: Optional[Any]             # backend snapshot or None
    t_s: float                       # sim time the checkpoint was taken


class HeartbeatMonitor:
    """Last-seen tracking with suspect/dead thresholds.

    The fleet feeds :meth:`beat` from its paced-probe machinery; the
    monitor never reads a clock itself — ``now`` is always the caller's
    sim time, so seeded replays are pure functions of their seed."""

    def __init__(self, names: Iterable[str], probe_every_s: float,
                 cfg: Optional[FailoverConfig] = None, t0: float = 0.0):
        self.cfg = cfg or FailoverConfig()
        self.probe_every_s = probe_every_s
        self.last_seen: Dict[str, float] = {n: t0 for n in names}

    def beat(self, name: str, now: float) -> None:
        """Record liveness: ``name`` executed a step or answered a probe."""
        self.last_seen[name] = now

    def gap(self, name: str, now: float) -> float:
        """Sim seconds since ``name`` was last seen."""
        return now - self.last_seen[name]

    def state(self, name: str, now: float) -> str:
        """``"alive"`` / ``"suspect"`` / ``"dead"`` from the beat gap."""
        g = self.gap(name, now)
        if g >= self.cfg.dead_after * self.probe_every_s:
            return DEAD
        if g >= self.cfg.suspect_after * self.probe_every_s:
            return SUSPECT
        return ALIVE
