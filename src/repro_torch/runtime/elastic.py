"""Elastic mitigation policies — the paper's §5.2 proposals, implemented
(a copy of ``repro/runtime/elastic.py``).

Three policies the paper sketches for its thermal problem, generalised to a
fleet:

* ``SwapPolicy``       — "swapping between multiple iOS workers, letting one
  cool down while another worked": maintain hot spares; when a worker goes
  SERIOUS, promote a spare into its pipeline slot and send the hot one to the
  cooling pool (re-admitted at MINIMAL).
* ``DutyCyclePolicy``  — "regulating compute loads to short bursts": insert
  idle fractions for hot workers (modelled as a per-worker throughput
  multiplier the trainer applies to microbatch assignment).
* ``RebalancePolicy``  — repartition stage boundaries with the cost model so
  a throttled worker gets fewer layers (the paper's split-point search, rerun
  online with updated device rates).

Policies consume :class:`repro_torch.runtime.monitor.ThermalMonitor` summaries and
emit Actions; the trainer / simulator executes them.

The same mitigations generalise from trainer stage-swaps to **live serving
traffic** (consumed by :class:`repro_torch.serving.fleet.ServingFleet`):
:class:`ServingElasticPolicy` emits ``drain`` (route new admissions away
from a hot worker), ``migrate`` (preempt its decode lanes token-identically
and re-admit them on a cooler worker) and ``duty_cycle`` (fewer decode
steps per fleet tick) actions, with hysteresis: a drained worker is
re-admitted (``undrain``) only once it cools back to MINIMAL.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

from repro_torch.core.partition import SplitPlan, split_blocks
from repro_torch.hw.specs import DeviceProfile
from repro_torch.runtime.monitor import ThermalMonitor, ThermalState, WorkerStats


@dataclasses.dataclass(frozen=True)
class Action:
    # trainer kinds: swap | duty_cycle | rebalance | none
    # serving kinds: drain | undrain | migrate | duty_cycle
    # scale kinds:   scale_up | scale_down
    kind: str
    worker: str = ""
    detail: dict = dataclasses.field(default_factory=dict)


class SwapPolicy:
    """Hot-spare promotion (paper: 'pipelining the devices themselves')."""

    def __init__(self, spares: Sequence[str]):
        self.spares: List[str] = list(spares)
        self.cooling: List[str] = []

    def step(self, monitor: ThermalMonitor) -> List[Action]:
        actions = []
        # re-admit cooled workers
        for w in list(self.cooling):
            ws = monitor.workers.get(w)
            if ws and ws.state == ThermalState.MINIMAL:
                self.cooling.remove(w)
                self.spares.append(w)
        for ws in monitor.stragglers(ThermalState.SERIOUS):
            if ws.worker in self.cooling:
                continue
            if not self.spares:
                break
            spare = self.spares.pop(0)
            self.cooling.append(ws.worker)
            # the spare inherits the hot worker's telemetry slot fresh
            monitor.workers.pop(ws.worker, None)
            actions.append(Action("swap", ws.worker,
                                  {"replacement": spare}))
        return actions


class DutyCyclePolicy:
    """Short-burst load regulation: throttle assignment to hot workers."""

    def __init__(self, serious_duty: float = 0.6, fair_duty: float = 0.85):
        self.serious_duty = serious_duty
        self.fair_duty = fair_duty

    def step(self, monitor: ThermalMonitor) -> List[Action]:
        actions = []
        for ws in monitor.workers.values():
            duty = 1.0
            if ws.state == ThermalState.FAIR:
                duty = self.fair_duty
            elif ws.state in (ThermalState.SERIOUS, ThermalState.CRITICAL):
                duty = self.serious_duty
            if duty < 1.0:
                actions.append(Action("duty_cycle", ws.worker, {"duty": duty}))
        return actions


class RebalancePolicy:
    """Online re-split: feed throttled rates back into the cost model."""

    def __init__(self, costs, devices: Sequence[DeviceProfile],
                 efficiency: float = 0.5, train: bool = True):
        self.costs = costs
        self.devices = list(devices)
        self.efficiency = efficiency
        self.train = train
        self.current: Optional[SplitPlan] = None

    def step(self, monitor: ThermalMonitor,
             worker_order: Sequence[str]) -> List[Action]:
        derated = []
        for name, dev in zip(worker_order, self.devices):
            ws = monitor.workers.get(name)
            rate = 1.0 / ws.slowdown if ws else 1.0
            derated.append(dataclasses.replace(dev, flops=dev.flops * rate))
        plan = split_blocks(self.costs, derated, self.efficiency, self.train)
        if self.current is not None and plan.cuts == self.current.cuts:
            return []
        prev = self.current
        self.current = plan
        return [Action("rebalance", "",
                       {"cuts": list(plan.cuts),
                        "prev": list(prev.cuts) if prev else None,
                        "bottleneck_s": plan.bottleneck})]


class ServingElasticPolicy:
    """§5.2 mitigations applied to live serving traffic.

    Consumed by the fleet (``ServingFleet``): every fleet tick
    the policy reads the :class:`ThermalMonitor` and emits

    * ``drain`` when a worker reaches ``drain_at`` — the fleet routes new
      admissions away from it (its queued backlog still drains through it);
    * ``migrate`` (edge-triggered, once per hot episode) when it reaches
      ``migrate_at`` — the fleet preempts its decode lanes (frozen sampler
      PRNG + generated-token requeue keep the resume token-identical) and
      re-admits them on the coolest non-drained worker.  With
      ``migrate_queued`` its queued backlog is re-routed too;
    * ``duty_cycle`` (delegated to :class:`DutyCyclePolicy`) for every
      FAIR-or-hotter worker — the fleet runs it for a fraction of each
      tick, trading throughput for heat;
    * ``undrain`` once a drained worker cools back to MINIMAL (hysteresis:
      it must fully recover, not merely dip below ``drain_at``).
    """

    def __init__(self, drain_at: ThermalState = ThermalState.SERIOUS,
                 migrate_at: ThermalState = ThermalState.SERIOUS,
                 duty: Optional[DutyCyclePolicy] = None,
                 migrate_queued: bool = True,
                 migrate_lanes: Optional[int] = None):
        self.drain_at = drain_at
        self.migrate_at = migrate_at
        self.duty = duty or DutyCyclePolicy()
        self.migrate_queued = migrate_queued
        # None = evict every lane; an int bounds the eviction to the N
        # cheapest victims (the fleet orders them by recompute cost and
        # footprint — see ServingFleet.migrate)
        self.migrate_lanes = migrate_lanes
        self.draining: Set[str] = set()
        self._migrated: Set[str] = set()    # hot episodes already migrated

    def step(self, monitor: ThermalMonitor) -> List[Action]:
        order = list(ThermalState)
        actions: List[Action] = []
        for ws in monitor.workers.values():
            rank = order.index(ws.state)
            if rank >= order.index(self.drain_at):
                if ws.worker not in self.draining:
                    self.draining.add(ws.worker)
                    actions.append(Action("drain", ws.worker,
                                          {"state": ws.state.value}))
                if (ws.worker not in self._migrated
                        and rank >= order.index(self.migrate_at)):
                    self._migrated.add(ws.worker)
                    actions.append(Action(
                        "migrate", ws.worker,
                        {"state": ws.state.value,
                         "queued": self.migrate_queued,
                         "lanes": self.migrate_lanes}))
            elif (ws.state == ThermalState.MINIMAL
                    and ws.worker in self.draining):
                self.draining.discard(ws.worker)
                self._migrated.discard(ws.worker)
                actions.append(Action("undrain", ws.worker))
        actions.extend(self.duty.step(monitor))
        return actions


# ---------------------------------------------------------------------------
# fleet-size elasticity (scale plane)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetLoad:
    """One tick's aggregate load reading of a serving fleet — the signal an
    :class:`AutoscalePolicy` scales against.  Produced by
    :meth:`repro_torch.serving.scale.SimFleet.load` (or any equivalent source)."""
    sim_t: float
    serving: int          # warmed, admitting workers (excl. retiring)
    warming: int          # scaled up, still streaming params over the link
    spare: int            # rows that could still be scaled up
    queue_depth: int      # requests queued across serving workers
    backlog_s: float      # mean predicted wait-to-first-token across workers
    backlog_max_s: float  # worst single worker's predicted wait
    hot_frac: float       # fraction of serving workers at SERIOUS or worse
    util_mean: float      # mean busy fraction of the last tick


class AutoscalePolicy:
    """Fleet-size sibling of :class:`ServingElasticPolicy`: spin replica
    workers (or split StageGroups — the fleet decides what a "row" is)
    up/down against queue backlog and thermal headroom.

    * **scale up** when predicted backlog exceeds ``target_wait_s`` or too
      many serving workers run hot (``hot_frac > hot_headroom`` — thermal
      pressure is capacity pressure on phones): add ``step_frac`` of the
      current fleet, bounded by spares and ``max_workers``.  New capacity
      is *not* free — the fleet charges each new worker's params over its
      link as warm-up bytes before it serves.
    * **scale down** when backlog stays below ``idle_wait_s`` and mean
      utilisation below ``idle_util`` for ``settle_reads`` consecutive
      readings: retire ``step_frac`` of the fleet (drain, then drop) down
      to ``min_workers``.  The sustained-low requirement plus
      ``cooldown_s`` between actions gives the same hysteresis flavour as
      ServingElasticPolicy's undrain rule — capacity should not flap with
      every burst.
    """

    def __init__(self, min_workers: int = 1, max_workers: int = 1 << 30, *,
                 target_wait_s: float = 1.0, idle_wait_s: float = 0.2,
                 hot_headroom: float = 0.25, idle_util: float = 0.35,
                 step_frac: float = 0.25, cooldown_s: float = 5.0,
                 settle_reads: int = 3):
        if min_workers < 0 or max_workers < min_workers:
            raise ValueError("need 0 <= min_workers <= max_workers")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.target_wait_s = target_wait_s
        self.idle_wait_s = idle_wait_s
        self.hot_headroom = hot_headroom
        self.idle_util = idle_util
        self.step_frac = step_frac
        self.cooldown_s = cooldown_s
        self.settle_reads = settle_reads
        self._last_action_t = float("-inf")
        self._low_reads = 0

    def _step_n(self, serving: int) -> int:
        return max(1, int(serving * self.step_frac))

    def step(self, load: FleetLoad) -> List[Action]:
        busy = (load.backlog_s > self.target_wait_s
                or load.hot_frac > self.hot_headroom)
        idle = (load.backlog_s < self.idle_wait_s
                and load.util_mean < self.idle_util
                and load.queue_depth == 0)
        self._low_reads = self._low_reads + 1 if idle else 0
        if load.sim_t - self._last_action_t < self.cooldown_s:
            return []
        provisioned = load.serving + load.warming
        if busy:
            n = min(self._step_n(provisioned), load.spare,
                    self.max_workers - provisioned)
            if n > 0:
                self._last_action_t = load.sim_t
                self._low_reads = 0
                return [Action("scale_up", "", {
                    "n": n, "backlog_s": load.backlog_s,
                    "hot_frac": load.hot_frac})]
            return []
        if idle and self._low_reads >= self.settle_reads:
            n = min(self._step_n(provisioned),
                    load.serving - self.min_workers)
            if n > 0:
                self._last_action_t = load.sim_t
                self._low_reads = 0
                return [Action("scale_down", "", {
                    "n": n, "backlog_s": load.backlog_s,
                    "util_mean": load.util_mean})]
        return []
