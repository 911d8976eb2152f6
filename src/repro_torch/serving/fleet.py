"""Thermal-aware heterogeneous serving fleet (paper §4.2 + §5.2, serving;
a copy of ``repro/serving/fleet.py`` over the port's engines).

The paper's core claim is that a weak host plus a thermally-throttled phone
can serve real workloads; its §5.2 mitigations (swap / duty-cycle /
rebalance) were implemented for the *training* runtime in
:mod:`repro_torch.runtime.elastic`.  This module puts the same machinery under
**live serving traffic**: a :class:`ServingFleet` runs one
:class:`~repro_torch.serving.engine.ServeEngine` per simulated heterogeneous
worker, paced in *simulated time* by the worker's
:class:`~repro_torch.hw.specs.DeviceProfile` serving rates
(``decode_steps_per_s`` / ``prefill_tokens_per_s``), and

* **routes** each admission to the worker with the coolest thermal state
  and the shortest estimated backlog (free backend capacity breaks ties);
* feeds per-step latency telemetry into a
  :class:`~repro_torch.runtime.monitor.ThermalMonitor` — the paper's EWMA
  state machine now watches serving steps instead of training batches;
* executes :class:`~repro_torch.runtime.elastic.ServingElasticPolicy` actions:
  a SERIOUS worker is **duty-cycled** (fewer decode steps per fleet tick),
  **drained** (new admissions routed away) or has its lanes **migrated** —
  ``engine.preempt(slot, requeue=False)`` releases the lane
  token-identically (frozen sampler PRNG + generated-token requeue) and
  ``inject(req, force=True)`` re-admits it on a cooler worker.  With
  content-addressed prefix caching enabled on the target, the migration
  re-prefill of shared-scaffold traffic is a near-full cache hit.

Simulation semantics: :meth:`ServingFleet.tick` advances simulated time by
``tick_s``.  A worker earns ``tick_s * duty`` seconds of compute per tick
and spends it on decode steps (``slowdown / decode_rate`` seconds each)
and prefill work (``prefilled_tokens * slowdown / prefill_rate``), where
``slowdown`` comes from a pluggable throttle model:

* :class:`ThrottleTrace` — exogenous per-worker ramp (paper Fig. 6 shape:
  plateau approach with a time constant), for deterministic benches;
* :class:`ThermalReservoir` — closed loop: heat integrates utilisation
  with the profile's ``thermal_tau_s``, idle time dissipates it, and
  slowdown ramps to ``1 / thermal_sustained`` at full heat — so
  duty-cycling genuinely cools a worker.

Fleet engines run on the fleet's SIM clock (``ServeEngine(clock=...)``):
``Request.deadline_s`` is evaluated against simulated seconds, and the
engines' latency metrics read in sim seconds too.  Fleet-level **goodput**
(completed tokens per simulated second, total and per worker), migration
counts and thermal-state occupancy remain the headline numbers
(:meth:`ServingFleet.snapshot`).

Telemetry is paid for, not free: a worker that executed steps this tick
reports their latency; an idle (usually drained) worker is only observed
through a paced **probe** (one step's compute charged against its budget,
every ``probe_every_s`` sim seconds) — so noticing that a drained worker
cooled down has a cost, as on a real fleet.  ``telemetry="wall"`` feeds
the monitor the *measured wall-clock* per-step latency of the real
dispatches instead of the synthetic simulated value — for replica workers
and for stage-group members alike (per-stage dispatch times) — and probes
then re-observe the last *measured* value (or skip, before any dispatch
ran), so the monitor's baseline never mixes wall and sim time scales.
The bench harness uses this mode to drive the monitor with real
telemetry.  In the port each measured window closes on a host sync: a
replica's or a spec pair's step ends by bringing the sampled tokens to
the host, and a stage's dispatch time is read after a device
synchronize, so the monitor sees the card's work, not launch times.

**Stage groups** (pipeline-split decode, paper §4.1 topology): a
:class:`StageGroup` pairs two or more member workers into ONE logical
serving unit running a :class:`~repro_torch.serving.pipeline_decode.PipelineEngine`
— stage 0 holds the below-the-cut layers (and their KV), stage 1 the
rest, and every boundary activation crosses as a wire frame charged
against ``min(link_bw)`` in sim time (a frame that outruns the tick's
link budget stays IN FLIGHT into the next tick).  The cut comes from
:func:`repro_torch.core.partition.split_decode`; when a member throttles, the
elastic ``migrate`` action is reinterpreted for its group as
**rebalance**: the split is re-cut from the members' derated rates, the
moved layer params are charged over the link, and every lane resumes
token-identically through the preempt/inject machinery.

**Failure plane** (``kill_trace=`` / ``failover=``): workers can DIE, not
just throttle.  A seeded :class:`~repro_torch.runtime.faults.KillTrace`
schedules crashes, network partitions and zombie-reboots; liveness is
heartbeats fed from this module's existing paced telemetry (every
executed step or paced probe beats — see
:mod:`repro_torch.serving.failover`), and a unit whose beats stop long enough
is declared dead: its lanes are rolled back to their last periodic
checkpoint and resurrected **token-identically** on survivors through
the same preempt/inject machinery migration uses, its queued backlog
re-routes, and nothing is ever lost (destination-less requests park and
retry).  ``FleetSnapshot`` reports ``deaths / resurrections /
recompute_tokens / orphaned / checkpoints``.

**Speculative pairs**: a :class:`SpecPair` welds a fast draft worker to a
slow target worker into ONE serving unit running a
:class:`~repro_torch.serving.speculative.SpecEngine` — the draft member
proposes ``spec_k`` tokens per round, the target member verifies them in
one multi-token window, and BOTH directions of the token exchange cross
as wire frames charged against ``min(link_bw)`` (transfers are never
free).  The elastic ``migrate`` action on the DRAFT member means
**colocate**: drafting falls back onto the target worker (draft compute
charged there, link charges vanish) until every member cools, when the
``undrain`` re-splits the pair.  ``migrate`` on the TARGET member drains
the pair — the target holds the lanes and the big params; there is
nowhere cheaper to verify.

**Training plane** (:mod:`repro_torch.serving.train_plane`): a
:class:`~repro_torch.serving.train_plane.FedRoundCoordinator` wraps the fleet
and schedules federated training rounds into replica workers' idle
duty-cycle gaps — local steps charged against the SAME per-tick ``acc_s``
credit decode spends (and feeding the same thermal loop through
``util``), update frames charged against the link, dead participants
excluded per round through this module's failure plane.  The fleet
itself stays training-agnostic; :meth:`ServingFleet.thermal_rank` is the
public face the coordinator scores and preempts on.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch.core.partition import split_decode
from repro_torch.hw.specs import DeviceProfile
from repro_torch.models.api import Model
from repro_torch.runtime.elastic import Action, ServingElasticPolicy
from repro_torch.runtime.faults import KillEvent, KillTrace
from repro_torch.runtime.monitor import ThermalMonitor, ThermalState
from repro_torch.serving.failover import (DEAD, SUSPECT, FailoverConfig,
                                    HeartbeatMonitor, LaneCheckpoint)
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.engine_api import DecodeEngine
from repro_torch.serving.metrics import EngineSnapshot
from repro_torch.serving.pipeline_decode import (PipelineEngine, StepReport,
                                           decode_block_costs,
                                           stage_fixed_mem)
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.speculative import SpecEngine, SpecReport


# ---------------------------------------------------------------------------
# throttle models
# ---------------------------------------------------------------------------
class NullThrottle:
    """No throttling: every worker always runs at its cold rate."""

    def advance(self, worker: str, dt: float, util: float) -> float:
        return 1.0


class ThrottleTrace:
    """Exogenous per-worker slowdown trace (paper Fig. 6 ramp shape).

    ``ramps`` maps worker name -> ``(start_s, factor, tau_s)``: from
    ``start_s`` of simulated time the slowdown approaches ``factor`` with
    time constant ``tau_s``.  Utilisation is ignored — the trace is the
    same whatever the policies do, which is exactly what a policies-on vs
    policies-off A/B needs.
    """

    def __init__(self, ramps: Dict[str, Tuple[float, float, float]]):
        self.ramps = dict(ramps)
        self._t: Dict[str, float] = {}

    def advance(self, worker: str, dt: float, util: float) -> float:
        t = self._t.get(worker, 0.0) + dt
        self._t[worker] = t
        if worker not in self.ramps:
            return 1.0
        start, factor, tau = self.ramps[worker]
        if t < start:
            return 1.0
        ramp = 1.0 - math.exp(-(t - start) / max(tau, 1e-9))
        return 1.0 + (factor - 1.0) * ramp


class ThermalReservoir:
    """Closed-loop thermal model driven by the profiles' §4.2 fields.

    Heat ``h`` in [0, 1] integrates utilisation with time constant
    ``thermal_tau_s`` and dissipates while idle (``cool_frac`` scales the
    cooling time constant); slowdown ramps to ``1 / thermal_sustained`` at
    full heat.  Duty-cycling a worker really cools it here — this is the
    model under which the §5.2 duty-cycle mitigation earns its keep.
    """

    def __init__(self, profiles: Dict[str, DeviceProfile],
                 cool_frac: float = 0.5):
        self.profiles = dict(profiles)
        self.cool_frac = cool_frac
        self.heat: Dict[str, float] = {}

    def advance(self, worker: str, dt: float, util: float) -> float:
        p = self.profiles.get(worker)
        if p is None or not math.isfinite(p.thermal_tau_s):
            return 1.0
        tau = max(p.thermal_tau_s, 1e-9)
        h = self.heat.get(worker, 0.0)
        h += dt * (util / tau
                   - (1.0 - util) * h / (tau * max(self.cool_frac, 1e-9)))
        h = min(max(h, 0.0), 1.0)
        self.heat[worker] = h
        return 1.0 + (1.0 / p.thermal_sustained - 1.0) * h


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One simulated worker: a device profile plus engine sizing."""
    name: str
    profile: DeviceProfile
    max_batch: int = 4
    engine_config: Optional[EngineConfig] = None    # None = fleet default
    scheduler: Optional[SchedulerConfig] = None     # None = fleet default


@dataclasses.dataclass(frozen=True)
class StageGroup:
    """Several member workers serving ONE model split across their engines.

    ``workers`` are the stage members in stage order (stage 0 first);
    ``cuts`` are the layer indices where each next stage starts, or
    ``None`` to let :func:`repro_torch.core.partition.split_decode` pick them
    from the members' device profiles (serving rates, link budgets and
    ``mem_bytes``).  The group routes, drains and migrates as one unit
    under its ``name``; its members keep their own thermal telemetry,
    duty cycles and throttle state under their worker names.
    """
    name: str
    workers: Tuple[WorkerSpec, ...]
    cuts: Optional[Tuple[int, ...]] = None
    max_batch: int = 4
    engine_config: Optional[EngineConfig] = None
    scheduler: Optional[SchedulerConfig] = None


@dataclasses.dataclass(frozen=True, eq=False)
class SpecPair:
    """A draft worker welded to a target worker for speculative decoding.

    ``draft`` runs ``draft_model`` (a small same-vocab proposer whose
    compute is charged at ``draft_share`` of a full decode step — default
    its layer count over the target's); ``target`` runs the fleet model
    and verifies ``spec_k``-token proposals in one window.  The pair
    routes, drains and migrates as one unit under ``name``; members keep
    their own thermal telemetry, duty cycles and throttle state.
    ``eq=False``: params pytrees aren't hashable, identity semantics are
    what a spec registry needs anyway.
    """
    name: str
    draft: WorkerSpec
    target: WorkerSpec
    draft_model: Model
    draft_params: object
    spec_k: int = 3
    draft_share: Optional[float] = None     # None = layer-count ratio
    max_batch: int = 4
    engine_config: Optional[EngineConfig] = None
    scheduler: Optional[SchedulerConfig] = None


@dataclasses.dataclass(frozen=True)
class CompletedRecord:
    """A finished request with fleet-level context."""
    req: Request
    worker: str                  # worker it FINISHED on
    sim_t: float                 # simulated completion time
    migrated: bool               # ever moved between workers


@dataclasses.dataclass(frozen=True)
class WorkerSnapshot:
    name: str
    profile: str
    engine: EngineSnapshot
    completed: int
    completed_tokens: int
    goodput_tokens_per_s: float      # tokens finished here / sim seconds
    steps_run: int
    duty: float
    drained: bool
    thermal_state: str
    slowdown: float
    state_occupancy: Dict[str, float]
    probes: int = 0                  # paced recovery probes paid


@dataclasses.dataclass(frozen=True)
class GroupSnapshot:
    """One stage group's reading: split shape, wire traffic, members."""
    name: str
    workers: Tuple[str, ...]         # member names, stage order
    cuts: Tuple[int, ...]
    engine: EngineSnapshot
    completed: int
    completed_tokens: int
    goodput_tokens_per_s: float
    steps_run: int                   # decode steps fully PAID in sim time
    drained: bool
    recuts: int                      # rebalance re-cuts applied
    frames_sent: int                 # boundary frames through the codec
    frame_bytes: int                 # activation bytes charged to the link
    recut_bytes: int                 # layer-param bytes moved by recuts
    transfer_s: float                # sim seconds the link was busy
    link_stall_ticks: int            # ticks a frame stayed in flight
    members: Dict[str, Dict]         # per member: duty/slowdown/state/util


@dataclasses.dataclass(frozen=True)
class SpecSnapshot:
    """One speculative pair's reading: acceptance, wire traffic, members.

    Units: ``frame_bytes`` are wire-codec bytes charged to the pair's
    link; ``transfer_s`` sim seconds the link was busy; acceptance
    metrics live in ``engine`` (``spec_acceptance_rate`` etc.)."""
    name: str
    workers: Tuple[str, str]         # (draft, target) member names
    spec_k: int
    draft_share: float
    engine: EngineSnapshot
    completed: int
    completed_tokens: int
    goodput_tokens_per_s: float
    rounds_run: int                  # draft->verify rounds fully PAID
    drained: bool
    colocated: bool                  # currently drafting on the target
    colocations: int                 # times the pair fell back colocated
    frame_bytes: int                 # drafted+sync bytes through the codec
    transfer_s: float
    link_stall_ticks: int
    members: Dict[str, Dict]


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    sim_t: float
    ticks: int
    completed: int
    completed_tokens: int
    goodput_tokens_per_s: float      # completed tokens / sim seconds
    migrations: int                  # lane moves (preempt here, resume there)
    migrated_requests: int           # unique requests whose decode ever
    #                                  moved workers (lane moves + queued
    #                                  mid-flight moves)
    queue_moves: int                 # queued requests re-routed off a worker
    drains: int
    undrains: int
    rejected: int
    expired: int
    per_worker: Dict[str, WorkerSnapshot]
    per_group: Dict[str, GroupSnapshot] = dataclasses.field(
        default_factory=dict)
    per_spec: Dict[str, SpecSnapshot] = dataclasses.field(
        default_factory=dict)
    recuts: int = 0                  # stage-group rebalances applied
    probes: int = 0                  # paced recovery probes across the fleet
    transfer_bytes: int = 0          # wire bytes charged (activations+recuts)
    transfer_s: float = 0.0          # sim seconds links were busy
    # failure plane (serving/failover.py): all zero without a kill trace
    deaths: int = 0                  # units declared DEAD by the heartbeat
    resurrections: int = 0           # mid-flight lanes resumed elsewhere
    recompute_tokens: int = 0        # tokens replayed by resurrections
    orphaned: int = 0                # stranded requests with no destination
    checkpoints: int = 0             # lane checkpoints taken
    dead_units: Tuple[str, ...] = ()

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class _Paced:
    """Sim-pacing state shared by plain workers and group members."""

    def __init__(self, spec: WorkerSpec):
        self.spec = spec
        self.duty = 1.0
        self.acc_s = 0.0             # unspent compute credit, seconds
        self.util = 0.0              # last tick's busy fraction
        self.slowdown = 1.0
        self.steps_run = 0
        self.next_probe_s = 0.0      # earliest sim time of the next probe
        self.probes = 0
        # last MEASURED wall-clock per-step latency (telemetry="wall"):
        # probes re-observe it so the monitor never mixes time scales
        self.last_wall_step_s: Optional[float] = None

    @property
    def name(self) -> str:
        return self.spec.name


class _Worker(_Paced):
    """Mutable runtime state the fleet keeps per replica WorkerSpec.

    The fleet drives ``engine`` strictly through the
    :class:`~repro_torch.serving.engine_api.DecodeEngine` protocol surface —
    any conforming engine routes, migrates and snapshots the same way
    (the replica builder instantiates :class:`ServeEngine`)."""

    def __init__(self, spec: WorkerSpec, engine: DecodeEngine):
        super().__init__(spec)
        self.engine = engine
        self.rate = spec.profile.decode_rate()
        self.prefill_rate = spec.profile.prefill_rate()
        self.drained = False
        self.n_collected = 0         # engine.finished entries already seen
        self.done_count = 0          # completed requests (incremental; the
        self.done_tokens = 0         # snapshot must not rescan the log)

    def free_fraction(self) -> float:
        """Free capacity in [0, 1]: pool budget fraction for budgeted
        backends (paged), free-lane fraction otherwise."""
        eng = self.engine
        budget = eng.backend.budget_tokens
        cap = eng.backend.capacity_tokens
        if budget is not None and cap:
            return budget / cap
        return (eng.max_batch - eng.active()) / eng.max_batch


@dataclasses.dataclass
class _Charge:
    """One unpaid cost of a stage group's in-flight work.

    ``kind`` is ``"stage"`` (compute on member ``idx``, remaining COLD
    seconds — the member's live slowdown scales it at payment time),
    ``"link"`` (remaining wire seconds on boundary ``idx``; a partially
    paid link charge IS an activation frame in flight between ticks) or
    ``"commit"`` (free: the step's results become visible — finished
    requests are collected at the sim time the costs finished)."""
    kind: str
    idx: int
    remaining: float


class _GroupRuntime:
    """Runtime state of one StageGroup: engine, members, charge queue."""

    def __init__(self, spec: StageGroup, engine: PipelineEngine,
                 members: List[_Paced], costs, fixed_mem):
        self.spec = spec
        self.engine = engine
        self.members = members
        self.costs = costs               # decode_block_costs at build time
        self.fixed_mem = fixed_mem
        self.drained = False
        self.n_collected = 0
        self.done_count = 0
        self.done_tokens = 0
        self.steps_run = 0
        self.pending: Deque[_Charge] = collections.deque()
        self.link_acc = 0.0              # unspent link time, seconds
        self.transfer_s = 0.0            # sim seconds spent on the wire
        self.frame_bytes = 0             # activation bytes charged
        self.recut_bytes = 0             # layer-param bytes moved by recuts
        self.link_stall_ticks = 0        # ticks a frame stayed in flight
        self.recuts = 0
        self._set_rates()

    @property
    def name(self) -> str:
        return self.spec.name

    def _set_rates(self) -> None:
        """Per-stage cold costs from the CURRENT cut (recomputed after a
        rebalance): a stage holding ``share`` of the layers costs
        ``share / decode_rate`` cold seconds per decode step and
        ``share / prefill_rate`` per prefill token on its member."""
        n = self.engine.model.cfg.n_layers
        bounds = (0,) + self.engine.cuts + (n,)
        devs = [m.spec.profile for m in self.members]
        self.step_cold = [(bounds[i + 1] - bounds[i]) / n
                          / devs[i].decode_rate()
                          for i in range(len(self.members))]
        self.prefill_cold = [(bounds[i + 1] - bounds[i]) / n
                             / devs[i].prefill_rate()
                             for i in range(len(self.members))]
        self.link_bw = [min(devs[i].link_bw, devs[i + 1].link_bw)
                        for i in range(len(self.members) - 1)]
        self.rate = 1.0 / sum(self.step_cold)    # cold steps/s (routing)

    def free_fraction(self) -> float:
        eng = self.engine
        return (eng.max_batch - eng.active()) / eng.max_batch

    def busy(self) -> bool:
        return bool(self.pending) or self.engine.active() > 0 \
            or self.engine.scheduler.depth > 0


class _SpecRuntime:
    """Runtime state of one SpecPair: engine, (draft, target) members,
    charge queue.  Pacing mirrors :class:`_GroupRuntime`: every
    eagerly-executed engine round becomes an ordered charge list — draft
    compute on member 0, the drafted-token frame's flight, verify compute
    on member 1, the sync frame back — and the queue drains as members
    earn compute credit and the link earns wire time."""

    def __init__(self, spec: SpecPair, engine: SpecEngine,
                 members: List[_Paced], draft_share: float):
        self.spec = spec
        self.engine = engine
        self.members = members           # [draft, target]
        self.draft_share = draft_share
        self.drained = False
        self.n_collected = 0
        self.done_count = 0
        self.done_tokens = 0
        self.steps_run = 0               # rounds fully paid in sim time
        self.pending: Deque[_Charge] = collections.deque()
        self.link_acc = 0.0
        self.transfer_s = 0.0
        self.frame_bytes = 0
        self.link_stall_ticks = 0
        self.colocations = 0
        d, t = (m.spec.profile for m in members)
        self.link_bw = min(d.link_bw, t.link_bw)
        # routing rate: tokens/s of a cold round at FULL acceptance — the
        # optimistic bound plays the same role decode_rate() plays for a
        # plain worker (backlog comparison, not billing)
        k = spec.spec_k
        round_cold = ((k + 1) * draft_share / d.decode_rate()
                      + 1.0 / t.decode_rate() + k / t.prefill_rate())
        self.rate = (k + 1) / round_cold

    @property
    def name(self) -> str:
        return self.spec.name

    def set_colocated(self, flag: bool) -> None:
        if flag and not self.engine.colocated:
            self.colocations += 1
        self.engine.colocated = flag

    def free_fraction(self) -> float:
        eng = self.engine
        return (eng.max_batch - eng.active()) / eng.max_batch

    def busy(self) -> bool:
        return bool(self.pending) or self.engine.active() > 0 \
            or self.engine.scheduler.depth > 0


_Routable = Union[_Worker, _GroupRuntime, _SpecRuntime]


def _ctx_len_of(req: Request) -> int:
    """Cache positions a re-prefill of ``req`` occupies (the engine's
    ``_ctx_len``, computed fleet-side for recompute accounting)."""
    n = len(req.prompt) + len(req.out_tokens)
    fe = req.extra.get("frontend")
    if fe is not None:
        n += fe.shape[0]
    return n


def _cache_tokens_of(req: Request) -> Optional[np.ndarray]:
    """Token content behind ``req``'s cache positions, or None when the
    positions aren't pure tokens (requests with extra model inputs can
    neither hit nor feed a prefix cache)."""
    if req.extra:
        return None
    if not req.out_tokens:
        return req.prompt
    return np.concatenate(
        [req.prompt, np.asarray(req.out_tokens, np.int32)])


class ServingFleet:
    """Heterogeneous serving fleet: replica workers + stage groups.

    Replica workers each run a full-params :class:`ServeEngine`; stage
    groups run ONE model split across their members' engines
    (:class:`~repro_torch.serving.pipeline_decode.PipelineEngine`), which is
    what lets the fleet serve models larger than any single worker's
    ``mem_bytes``.  Both route, drain and migrate as units under their
    names.
    """

    def __init__(self, model: Model, params,
                 workers: Sequence[WorkerSpec] = (), *,
                 groups: Sequence[StageGroup] = (),
                 spec_pairs: Sequence[SpecPair] = (),
                 max_len: int = 64,
                 tick_s: float = 0.05,
                 monitor: Optional[ThermalMonitor] = None,
                 policy: Optional[ServingElasticPolicy] = None,
                 throttle=None,
                 engine_config: Optional[EngineConfig] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 thermal_routing: bool = True,
                 telemetry: str = "sim",
                 probe_every_s: float = 0.25,
                 kill_trace: Optional[KillTrace] = None,
                 failover: Optional[FailoverConfig] = None):
        if not workers and not groups and not spec_pairs:
            raise ValueError(
                "a fleet needs at least one worker, group or spec pair")
        names = ([w.name for w in workers] + [g.name for g in groups]
                 + [m.name for g in groups for m in g.workers]
                 + [p.name for p in spec_pairs]
                 + [m.name for p in spec_pairs
                    for m in (p.draft, p.target)])
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker/group names: {names}")
        if telemetry not in ("sim", "wall"):
            raise ValueError(f"telemetry must be 'sim' or 'wall', "
                             f"got {telemetry!r}")
        self.tick_s = tick_s
        self.monitor = monitor or ThermalMonitor(
            alpha=0.25, calibration_steps=3, warmup_skip=0)
        self.policy = policy
        self.throttle = throttle or NullThrottle()
        # False = route on capacity/backlog alone (the thermally-naive
        # baseline a policies-off A/B measures against)
        self.thermal_routing = thermal_routing
        self.telemetry = telemetry
        self.probe_every_s = probe_every_s
        self.workers: List[_Worker] = []
        for spec in workers:
            eng = ServeEngine(
                model, params, max_batch=spec.max_batch, max_len=max_len,
                scheduler=spec.scheduler or scheduler,
                prefill_buckets=prefill_buckets,
                config=spec.engine_config or engine_config,
                clock=self._sim_now)
            self.workers.append(_Worker(spec, eng))
        self.groups: List[_GroupRuntime] = []
        self._member_group: Dict[str, _GroupRuntime] = {}
        for gspec in groups:
            g = self._build_group(model, params, gspec, max_len, scheduler)
            self.groups.append(g)
            for m in g.members:
                self._member_group[m.name] = g
        self.spec_pairs: List[_SpecRuntime] = []
        self._member_spec: Dict[str, _SpecRuntime] = {}
        for pspec in spec_pairs:
            s = self._build_spec(model, params, pspec, max_len, scheduler)
            self.spec_pairs.append(s)
            for m in s.members:
                self._member_spec[m.name] = s
        self._by_name: Dict[str, _Routable] = {
            u.name: u for u in (*self.workers, *self.groups,
                                *self.spec_pairs)}
        self.sim_t = 0.0
        self.ticks = 0
        self._rid = 0
        self.completed: List[CompletedRecord] = []
        self.completed_tokens = 0    # kept incrementally by _collect_finished
        self.routed: Dict[int, str] = {}      # rid -> first unit routed to
        self.action_log: List[Tuple[float, Action]] = []   # (sim_t, action)
        self.migrations = 0
        self.queue_moves = 0
        self.drains = 0
        self.undrains = 0
        self.recuts = 0
        self.routing_rejected = 0    # no routable worker could queue it
        self._migrated_rids: Set[int] = set()
        # ---- failure plane (serving/failover.py) ----------------------
        # failover defaults ON whenever a kill trace is supplied; passing
        # a FailoverConfig alone also arms it (heartbeats + checkpoints
        # run even if nothing ever dies — that is their real cost)
        self.failover = failover or (FailoverConfig()
                                     if kill_trace is not None else None)
        self._kill_events: List[KillEvent] = \
            sorted(kill_trace, key=lambda e: e.t_s) if kill_trace else []
        self._next_kill = 0
        self._down: Dict[str, str] = {}        # unit name -> kill kind
        self._return_at: Dict[str, float] = {}
        self._dead: Set[str] = set()           # DETECTED dead units
        self._suspect: Set[str] = set()
        self._parked: List[Tuple[Request, bool, bool]] = []
        self._parked_rids: Set[int] = set()
        self._ckpt: Dict[int, LaneCheckpoint] = {}
        self.deaths = 0
        self.resurrections = 0
        self.recompute_tokens = 0
        self.checkpoints = 0
        self.failure_log: List[Tuple[float, str, str]] = []
        if self.failover is not None:
            member_names = [p.name for p in self._all_paced()]
            self._hb: Optional[HeartbeatMonitor] = HeartbeatMonitor(
                member_names, probe_every_s, self.failover)
            self._next_ckpt_s = self.failover.checkpoint_every_s
        else:
            self._hb = None
            self._next_ckpt_s = math.inf

    def _sim_now(self) -> float:
        """The fleet's engines live on this SIM clock: queue waits and
        deadlines are simulated seconds, not host wall time."""
        return self.sim_t

    def _all_paced(self) -> List[_Paced]:
        """Every heartbeat-bearing entity: workers, group members, spec
        members (the paced things that execute steps and answer probes)."""
        return [*self.workers,
                *(m for g in self.groups for m in g.members),
                *(m for s in self.spec_pairs for m in s.members)]

    def _unit_paced(self, u: _Routable) -> List[_Paced]:
        return u.members if isinstance(u, (_GroupRuntime, _SpecRuntime)) \
            else [u]

    def _owning_unit(self, worker: str) -> Optional[_Routable]:
        """The routable unit a kill on ``worker`` takes down: a group or
        spec pair dies whole when any member does (a pipeline can't run
        around a missing stage; a pair can't verify on a dead target)."""
        if worker in self._member_group:
            return self._member_group[worker]
        if worker in self._member_spec:
            return self._member_spec[worker]
        return self._by_name.get(worker)

    def _is_down(self, name: str) -> bool:
        return name in self._down or name in self._dead

    def _beat(self, name: str) -> None:
        if self._hb is not None:
            self._hb.beat(name, self.sim_t)

    def _build_group(self, model: Model, params, gspec: StageGroup,
                     max_len: int,
                     scheduler: Optional[SchedulerConfig]) -> _GroupRuntime:
        if len(gspec.workers) < 2:
            raise ValueError(f"stage group {gspec.name!r} needs >= 2 "
                             f"member workers")
        costs = decode_block_costs(model, params, gspec.max_batch, max_len)
        fixed = stage_fixed_mem(model, params, len(gspec.workers))
        cuts = gspec.cuts
        if cuts is None:
            plan = split_decode(costs, [w.profile for w in gspec.workers],
                                stage_fixed_mem=fixed)
            cuts = plan.cuts
        eng = PipelineEngine(model, params, max_batch=gspec.max_batch,
                             max_len=max_len, cuts=cuts,
                             scheduler=gspec.scheduler or scheduler,
                             config=gspec.engine_config,
                             clock=self._sim_now)
        members = [_Paced(w) for w in gspec.workers]
        return _GroupRuntime(gspec, eng, members, costs, fixed)

    def _build_spec(self, model: Model, params, pspec: SpecPair,
                    max_len: int,
                    scheduler: Optional[SchedulerConfig]) -> _SpecRuntime:
        eng = SpecEngine(model, params, pspec.draft_model,
                         pspec.draft_params, max_batch=pspec.max_batch,
                         max_len=max_len, spec_k=pspec.spec_k,
                         scheduler=pspec.scheduler or scheduler,
                         config=pspec.engine_config, clock=self._sim_now)
        share = pspec.draft_share
        if share is None:
            share = (pspec.draft_model.cfg.n_layers
                     / max(model.cfg.n_layers, 1))
        members = [_Paced(pspec.draft), _Paced(pspec.target)]
        return _SpecRuntime(pspec, eng, members, share)

    # ------------------------------------------------------------------
    # admission routing
    # ------------------------------------------------------------------
    def worker(self, name: str) -> _Routable:
        return self._by_name[name]

    def group(self, name: str) -> _GroupRuntime:
        u = self._by_name[name]
        if not isinstance(u, _GroupRuntime):
            raise KeyError(f"{name!r} is not a stage group")
        return u

    def _state_rank(self, name: str) -> int:
        ws = self.monitor.workers.get(name)
        order = list(ThermalState)
        return order.index(ws.state) if ws else 0

    def thermal_rank(self, name: str) -> int:
        """Public thermal rank of one worker: 0 MINIMAL .. 3 CRITICAL.
        The training plane scores participant selection and preemption on
        this without reaching into the monitor."""
        return self._state_rank(name)

    def _unit_rank(self, u: _Routable) -> int:
        """A group/pair is as hot as its hottest member: one throttled
        stage (or the verify side) throttles every lane spanning it."""
        if isinstance(u, (_GroupRuntime, _SpecRuntime)):
            return max(self._state_rank(m.name) for m in u.members)
        return self._state_rank(u.name)

    def _route_order(self, exclude: Optional[_Routable] = None
                     ) -> List[_Routable]:
        """Routable units best-first: non-drained coolest state, then
        shortest estimated backlog (queued + active work over the unit's
        cold rate), then most free backend capacity.  All-drained fleets
        fall back to every unit — admissions queue rather than vanish.
        Units the heartbeat monitor declared DEAD are never routable;
        SUSPECT units are avoided like drained ones (fall back only when
        nothing healthy remains) — their lanes keep decoding, but new
        work shouldn't bet on a worker that stopped answering."""
        units: List[_Routable] = [u for u in (*self.workers, *self.groups,
                                              *self.spec_pairs)
                                  if u.name not in self._dead]
        cands = [u for u in units if u is not exclude and not u.drained
                 and u.name not in self._suspect]
        if not cands:
            cands = [u for u in units if u is not exclude]

        def score(u: _Routable):
            backlog = (u.engine.scheduler.depth + u.engine.active()) / u.rate
            rank = self._unit_rank(u) if self.thermal_routing else 0
            return (rank, backlog, -u.free_fraction(), u.name)

        return sorted(cands, key=score)

    def submit(self, prompt, max_new: int = 16,
               sampling: Optional[SamplingParams] = None, priority: int = 0,
               deadline_s: Optional[float] = None, **extra) -> Optional[int]:
        """Route one request to the best worker; returns a fleet-wide rid,
        or None if every routable worker's queue is full."""
        rid = self._rid
        self._rid += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new, extra,
                      submitted_t=self.sim_t,
                      sampling=sampling or GREEDY, priority=priority,
                      deadline_s=deadline_s)
        fallback = None
        for w in self._route_order():
            # probe capacity BEFORE inject: a push into a full queue would
            # record a per-engine rejection for a request another worker
            # then admits (one fleet admission must count at most once)
            mq = w.engine.scheduler.config.max_queue
            if mq is not None and w.engine.scheduler.depth >= mq:
                continue
            if fallback is None:
                fallback = w
            # don't route onto a backend that can never hold the final
            # footprint while a worker that can is standing by
            if not w.engine.feasible(req):
                continue
            if w.engine.inject(req):
                self.routed[rid] = w.name
                return rid
        if fallback is not None and fallback.engine.inject(req):
            # no worker fits it: queue it anyway so the backend's alloc —
            # the authority on infeasibility — records the rejection
            self.routed[rid] = fallback.name
            return rid
        self.routing_rejected += 1
        return None

    # ------------------------------------------------------------------
    # simulation
    # ------------------------------------------------------------------
    def _collect_finished(self, u: _Routable) -> None:
        done = u.engine.finished
        for req in done[u.n_collected:]:
            self.completed.append(CompletedRecord(
                req, u.name, self.sim_t, req.rid in self._migrated_rids))
            # incremental per-unit + fleet totals: snapshot() must stay
            # O(units), not O(units x completed-request log)
            toks = len(req.out_tokens)
            u.done_count += 1
            u.done_tokens += toks
            self.completed_tokens += toks
            self._ckpt.pop(req.rid, None)    # checkpoint no longer needed
        u.n_collected = len(done)

    def _observe_or_probe(self, p: _Paced, ran: bool,
                          reading: Optional[float],
                          probe_cost: float) -> float:
        """Telemetry with a cost model: a worker that executed work this
        tick reports its step latency for free (the steps themselves were
        the observation).  An idle worker — drained, starved or stalled —
        is only observed through a paced PROBE every ``probe_every_s``
        sim seconds; the probe costs one step's compute (returned, so the
        caller charges it), because on a real fleet noticing that a
        drained phone cooled down means running something on it.

        ``reading`` is the latency to feed the monitor — the simulated
        step time, or under ``telemetry="wall"`` the measured wall value
        (a probe re-observes the LAST measured one, never a sim-scale
        stand-in: the monitor's baseline must stay on one time scale).
        ``None`` = no reading exists yet (wall mode before any dispatch
        ran): the observation is skipped rather than polluted."""
        if ran:
            if reading is not None:
                self.monitor.observe(p.name, reading)
            p.next_probe_s = self.sim_t + self.probe_every_s
            self._beat(p.name)       # executed work IS the heartbeat
            return 0.0
        if self.sim_t >= p.next_probe_s:
            p.next_probe_s = self.sim_t + self.probe_every_s
            # a probe that reaches the worker proves liveness even when
            # it carries no monitor reading yet (wall mode, pre-dispatch)
            self._beat(p.name)
            if reading is None:
                return 0.0
            p.probes += 1
            self.monitor.observe(p.name, reading)
            return probe_cost
        return 0.0

    def _advance_worker(self, w: _Worker) -> None:
        w.slowdown = self.throttle.advance(w.name, self.tick_s, w.util)
        step_s = w.slowdown / w.rate
        w.acc_s = min(w.acc_s + self.tick_s * w.duty, self.tick_s + step_s)
        busy_s = 0.0
        wall_s = 0.0
        steps_ran = 0
        while w.acc_s >= step_s:
            if not w.engine.active() and not w.engine.scheduler.depth:
                # idle: credit does not bank beyond one immediate step
                w.acc_s = min(w.acc_s, step_s)
                break
            tok0 = w.engine.metrics.prefill_tokens
            t0 = time.perf_counter()
            w.engine.step()
            wall_s += time.perf_counter() - t0
            self._collect_finished(w)
            prefill_s = ((w.engine.metrics.prefill_tokens - tok0)
                         * w.slowdown / w.prefill_rate)
            w.acc_s -= step_s + prefill_s
            busy_s += step_s + prefill_s
            w.steps_run += 1
            steps_ran += 1
        # telemetry: the simulated per-step latency, or — under
        # telemetry="wall" — the MEASURED wall time of the real
        # dispatches (the bench harness's real-telemetry feed); probes
        # re-observe the last measured value so scales never mix
        if self.telemetry == "wall":
            if steps_ran:
                w.last_wall_step_s = wall_s / steps_ran
            reading = w.last_wall_step_s
        else:
            reading = step_s
        busy_s += self._observe_or_probe(w, steps_ran > 0, reading, step_s)
        w.util = min(busy_s / self.tick_s, 1.0)

    # -- stage groups ---------------------------------------------------
    def _charges_for(self, g: _GroupRuntime,
                     rep: StepReport) -> List[_Charge]:
        """Turn one eagerly-executed engine step into its sim-time costs,
        in pipeline order: per-stage prefill compute with the prompt
        activation frames between them, then per-stage decode compute
        with the decode boundary frames, then the free commit marker."""
        out: List[_Charge] = []
        n = len(g.members)
        if rep.prefill_tokens:
            for i in range(n):
                out.append(_Charge(
                    "stage", i, rep.prefill_tokens * g.prefill_cold[i]))
                if i < n - 1 and rep.prefill_frame_bytes[i]:
                    nb = rep.prefill_frame_bytes[i]
                    g.frame_bytes += nb
                    out.append(_Charge("link", i, nb / g.link_bw[i]))
        if rep.decode_step:
            for i in range(n):
                out.append(_Charge("stage", i, g.step_cold[i]))
                # wall telemetry feed: the measured per-stage dispatch time
                g.members[i].last_wall_step_s = rep.decode_stage_wall_s[i]
                if i < n - 1:
                    nb = rep.decode_frame_bytes[i]
                    g.frame_bytes += nb
                    out.append(_Charge("link", i, nb / g.link_bw[i]))
        out.append(_Charge("commit", 0, 0.0))
        return out

    def _advance_group(self, g: _GroupRuntime) -> None:
        """One tick of a stage group: members earn compute credit, the
        link earns wire time, and the charge queue drains in order — a
        decode step's stage-0 compute, its activation frame's flight, its
        stage-1 compute.  A frame whose flight outruns the tick's link
        budget stays IN FLIGHT into the next tick (that is the
        "activations cross between fleet ticks" semantics); compute that
        outruns a member's budget stalls the pipeline the same way."""
        n = len(g.members)
        for m in g.members:
            m.slowdown = self.throttle.advance(m.name, self.tick_s, m.util)
            m.acc_s = min(m.acc_s + self.tick_s * m.duty, self.tick_s)
        g.link_acc = min(g.link_acc + self.tick_s, self.tick_s)
        busy = [0.0] * n
        ran = [0] * n
        while True:
            if g.pending:
                ch = g.pending[0]
                if ch.kind == "stage":
                    m = g.members[ch.idx]
                    cost_now = ch.remaining * m.slowdown
                    pay = min(cost_now, m.acc_s)
                    m.acc_s -= pay
                    busy[ch.idx] += pay
                    ch.remaining -= pay / m.slowdown if m.slowdown else pay
                    if ch.remaining > 1e-12:
                        break                    # stage stalls into next tick
                    g.pending.popleft()
                    m.steps_run += 1
                    ran[ch.idx] += 1
                elif ch.kind == "link":
                    pay = min(ch.remaining, g.link_acc)
                    g.link_acc -= pay
                    g.transfer_s += pay
                    ch.remaining -= pay
                    if ch.remaining > 1e-12:
                        g.link_stall_ticks += 1  # frame crosses the tick
                        break
                    g.pending.popleft()
                else:                            # commit: results visible
                    g.pending.popleft()
                    g.steps_run += 1
                    self._collect_finished(g)
                continue
            if not (g.engine.active() or g.engine.scheduler.depth):
                break
            if all(m.acc_s <= 1e-12 for m in g.members):
                break                            # no stage could even start
            rep = g.engine.step_paced()
            if rep is None:
                break
            g.pending.extend(self._charges_for(g, rep))
        for i, m in enumerate(g.members):
            sim_step = g.step_cold[i] * m.slowdown
            reading = m.last_wall_step_s if self.telemetry == "wall" \
                else sim_step
            busy[i] += self._observe_or_probe(m, ran[i] > 0, reading,
                                              sim_step)
            m.util = min(busy[i] / self.tick_s, 1.0)

    # -- speculative pairs ---------------------------------------------
    def _spec_costs(self, s: _SpecRuntime) -> Tuple[float, float]:
        """Cold seconds of one round's (draft, verify) compute charges.
        Draft: k+1 token-steps (catch-up + k proposals) at the draft's
        layer share, on whichever member is currently drafting.  Verify:
        one decode step plus k extra window positions priced at the
        target's prefill rate (the window is one scanned dispatch, not
        k+1 separate decode steps — that IS the speedup)."""
        k = s.spec.spec_k
        di = 1 if s.engine.colocated else 0
        dprof = s.members[di].spec.profile
        tprof = s.members[1].spec.profile
        draft_s = (k + 1) * s.draft_share / dprof.decode_rate()
        verify_s = 1.0 / tprof.decode_rate() + k / tprof.prefill_rate()
        return draft_s, verify_s

    def _charges_for_spec(self, s: _SpecRuntime,
                          rep: SpecReport) -> List[_Charge]:
        """One eagerly-executed speculative round as ordered sim-time
        costs: admission prefills, draft compute, the drafted-token frame
        d->t, the verify window, the emitted/PRNG sync frame t->d, then
        the free commit marker.  Colocated pairs charge draft compute on
        the TARGET member (idx 1) and ship no frames (the report's byte
        counts are already zero)."""
        out: List[_Charge] = []
        di = 1 if s.engine.colocated else 0
        dprof = s.members[di].spec.profile
        tprof = s.members[1].spec.profile
        if rep.target_prefill_tokens:
            out.append(_Charge(
                "stage", 1,
                rep.target_prefill_tokens / tprof.prefill_rate()))
        if rep.draft_prefill_tokens:
            out.append(_Charge(
                "stage", di, rep.draft_prefill_tokens * s.draft_share
                / dprof.prefill_rate()))
        if rep.n_active:
            draft_s, verify_s = self._spec_costs(s)
            out.append(_Charge("stage", di, draft_s))
            if rep.d2t_frame_bytes:
                s.frame_bytes += rep.d2t_frame_bytes
                out.append(_Charge(
                    "link", 0, rep.d2t_frame_bytes / s.link_bw))
            out.append(_Charge("stage", 1, verify_s))
            if rep.t2d_frame_bytes:
                s.frame_bytes += rep.t2d_frame_bytes
                out.append(_Charge(
                    "link", 0, rep.t2d_frame_bytes / s.link_bw))
        out.append(_Charge("commit", 0, 0.0))
        return out

    def _advance_spec(self, s: _SpecRuntime) -> None:
        """One tick of a spec pair: same charge-queue drain as a stage
        group — draft compute, frame flight, verify compute, frame
        flight, commit — with frames crossing ticks when they outrun the
        link budget."""
        for m in s.members:
            m.slowdown = self.throttle.advance(m.name, self.tick_s, m.util)
            m.acc_s = min(m.acc_s + self.tick_s * m.duty, self.tick_s)
        s.link_acc = min(s.link_acc + self.tick_s, self.tick_s)
        busy = [0.0] * len(s.members)
        ran = [0] * len(s.members)
        while True:
            if s.pending:
                ch = s.pending[0]
                if ch.kind == "stage":
                    m = s.members[ch.idx]
                    cost_now = ch.remaining * m.slowdown
                    pay = min(cost_now, m.acc_s)
                    m.acc_s -= pay
                    busy[ch.idx] += pay
                    ch.remaining -= pay / m.slowdown if m.slowdown else pay
                    if ch.remaining > 1e-12:
                        break
                    s.pending.popleft()
                    m.steps_run += 1
                    ran[ch.idx] += 1
                elif ch.kind == "link":
                    pay = min(ch.remaining, s.link_acc)
                    s.link_acc -= pay
                    s.transfer_s += pay
                    ch.remaining -= pay
                    if ch.remaining > 1e-12:
                        s.link_stall_ticks += 1
                        break
                    s.pending.popleft()
                else:                            # commit: results visible
                    s.pending.popleft()
                    s.steps_run += 1
                    self._collect_finished(s)
                continue
            if not (s.engine.active() or s.engine.scheduler.depth):
                break
            if all(m.acc_s <= 1e-12 for m in s.members):
                break
            t0 = time.perf_counter()
            rep = s.engine.step_paced()
            wall = time.perf_counter() - t0
            if (rep.n_active == 0 and not rep.target_prefill_tokens
                    and not rep.draft_prefill_tokens):
                break
            # wall-telemetry feed: split the measured round time by the
            # members' cold-cost shares (one process runs both sides)
            draft_s, verify_s = self._spec_costs(s)
            tot = draft_s + verify_s
            s.members[0].last_wall_step_s = wall * draft_s / tot
            s.members[1].last_wall_step_s = wall * verify_s / tot
            s.pending.extend(self._charges_for_spec(s, rep))
        draft_s, verify_s = self._spec_costs(s)
        for i, m in enumerate(s.members):
            sim_step = (draft_s, verify_s)[i] * m.slowdown
            reading = m.last_wall_step_s if self.telemetry == "wall" \
                else sim_step
            busy[i] += self._observe_or_probe(m, ran[i] > 0, reading,
                                              sim_step)
            m.util = min(busy[i] / self.tick_s, 1.0)

    def tick(self) -> None:
        """Advance simulated time by ``tick_s``: run every worker's and
        group's share of work, feed telemetry, then apply policy
        actions.  With the failure plane armed, down units are skipped
        (a dead device executes nothing, beats nothing), the heartbeat
        monitor is evaluated after the advance, and lane checkpoints /
        parked-request retries run on their cadence."""
        self.sim_t += self.tick_s
        self.ticks += 1
        if self.failover is not None:
            self._process_returns()
            self._process_kills()
        for w in self.workers:
            if not self._is_down(w.name):
                self._advance_worker(w)
        for g in self.groups:
            if not self._is_down(g.name):
                self._advance_group(g)
        for s in self.spec_pairs:
            if not self._is_down(s.name):
                self._advance_spec(s)
        if self.failover is not None:
            self._detect_failures()
            self._checkpoint_lanes()
            self._retry_parked()
        if self.policy is not None:
            actions = self.policy.step(self.monitor)
            # duty is re-asserted every tick while a worker is hot; a
            # worker the policy stopped mentioning runs full-duty again
            asserted = {a.worker for a in actions if a.kind == "duty_cycle"}
            for p in (*self.workers,
                      *(m for g in self.groups for m in g.members),
                      *(m for s in self.spec_pairs for m in s.members)):
                if p.name not in asserted:
                    p.duty = 1.0
            self._apply(actions)

    def idle(self) -> bool:
        return (not self._parked
                and all(not w.engine.active() and not w.engine.scheduler.depth
                        for w in self.workers)
                and all(not g.busy() for g in self.groups)
                and all(not s.busy() for s in self.spec_pairs))

    def run_until_drained(self, max_ticks: int = 100_000
                          ) -> List[CompletedRecord]:
        for _ in range(max_ticks):
            if self.idle():
                break
            self.tick()
        else:
            if not self.idle():
                warnings.warn(
                    f"fleet run_until_drained exhausted max_ticks="
                    f"{max_ticks} with work outstanding — returning "
                    f"PARTIAL results ({len(self.completed)} finished)",
                    RuntimeWarning, stacklevel=2)
        return self.completed

    # ------------------------------------------------------------------
    # failure plane: kills, heartbeats, lane resurrection
    # ------------------------------------------------------------------
    def _unit_backends(self, u: _Routable) -> List:
        """Every cache backend a unit owns (pipeline: one per stage;
        spec pair: target + draft) — the zombie cold-rejoin flush set."""
        eng = u.engine
        stages = getattr(eng, "stages", None)
        if stages is not None:
            return [st.backend for st in stages]
        out = [eng.backend]
        draft = getattr(eng, "draft_backend", None)
        if draft is not None:
            out.append(draft)
        return out

    def _process_kills(self) -> None:
        """Apply due kill-trace events: the owning unit stops executing
        (and beating) from this tick on.  Nothing else happens yet — the
        fleet only learns of the death when the heartbeat gap crosses
        the dead threshold, exactly like a real control plane."""
        while (self._next_kill < len(self._kill_events)
               and self._kill_events[self._next_kill].t_s <= self.sim_t):
            ev = self._kill_events[self._next_kill]
            self._next_kill += 1
            unit = self._owning_unit(str(ev.worker))
            if unit is None or self._is_down(unit.name):
                continue
            self._down[unit.name] = ev.kind
            if ev.returns:
                self._return_at[unit.name] = ev.t_s + ev.down_s
            self.failure_log.append(
                (self.sim_t, f"kill:{ev.kind}", unit.name))

    def _process_returns(self) -> None:
        """Bring due partition/zombie units back.  A partition that heals
        BEFORE detection is a transparent blip: lanes and caches are
        intact and decode just resumes.  A unit that was declared dead
        rejoins as a fresh worker (its lanes were already resurrected
        elsewhere); a zombie additionally rejoins COLD — its caches are
        flushed, since reboot wiped the content behind every
        registration.  Pacing and heartbeats restart at rejoin so banked
        sim credit can't burst and detection doesn't instantly re-fire."""
        due = sorted(n for n, t in self._return_at.items()
                     if t <= self.sim_t)
        for name in due:
            del self._return_at[name]
            kind = self._down.pop(name, None)
            unit = self._by_name[name]
            self._dead.discard(name)
            self._suspect.discard(name)
            if kind == "zombie":
                for b in self._unit_backends(unit):
                    b.forget_cache()
            for p in self._unit_paced(unit):
                p.acc_s = 0.0
                p.next_probe_s = self.sim_t + self.probe_every_s
                self._beat(p.name)
            self.failure_log.append((self.sim_t, f"return:{kind}", name))

    def _detect_failures(self) -> None:
        """Heartbeat evaluation: a unit is DEAD when ANY member's beat
        gap crosses the dead threshold (a pipeline can't run around a
        missing stage), SUSPECT when any member crossed the suspect
        threshold — routed around, lanes untouched."""
        for u in (*self.workers, *self.groups, *self.spec_pairs):
            if u.name in self._dead:
                continue
            states = [self._hb.state(p.name, self.sim_t)
                      for p in self._unit_paced(u)]
            if DEAD in states:
                self._strand(u)
            elif SUSPECT in states:
                if u.name not in self._suspect:
                    self._suspect.add(u.name)
                    self.failure_log.append((self.sim_t, "suspect", u.name))
            else:
                self._suspect.discard(u.name)

    def _strand(self, u: _Routable) -> None:
        """Declare a unit dead and resurrect its work elsewhere: every
        active lane is forgotten (host bookkeeping freed, NOTHING saved
        from or registered by the unreachable device), rolled back to
        its last checkpoint and re-injected on a survivor; the queued
        backlog re-routes the way a drain-migration would.  Zero lost
        requests: anything with no feasible destination parks and
        retries every tick."""
        self._dead.add(u.name)
        self._suspect.discard(u.name)
        self.deaths += 1
        self.failure_log.append((self.sim_t, "dead", u.name))
        eng = u.engine
        pending = getattr(u, "pending", None)
        if pending is not None:
            # charge-paced units (groups / spec pairs) execute EAGERLY and
            # only deliver when the charge queue commits in sim time.  A
            # result whose commit was never paid was never delivered — the
            # device died first — so those requests resurrect too, and the
            # unpayable charges vanish with the unit.
            for req in eng.finished[u.n_collected:]:
                req.done_t = None
                self._rollback_to_ckpt(req)
                self._place(req, mid_flight=True, resurrect=True)
            del eng.finished[u.n_collected:]
            pending.clear()
        for slot in range(eng.max_batch):
            if eng.slots[slot] is None:
                continue
            req = eng.forget_lane(slot)
            self._rollback_to_ckpt(req)
            self._place(req, mid_flight=True, resurrect=True)
        for req in eng.pull_queued():
            # queued mid-flight requests (preempted earlier) carry valid
            # host-side saved state — no rollback, just a new home
            self._place(req, mid_flight=req.admitted_t is not None)

    def _rollback_to_ckpt(self, req: Request) -> None:
        """Restore a dead lane's request to its last checkpoint: tokens
        generated after the checkpoint are replayed on the survivor from
        the frozen PRNG counter, so the resumed stream is token-identical
        to the unkilled one.  No checkpoint = restart from scratch (still
        token-identical: admission re-seeds the sampling stream)."""
        n_out = len(req.out_tokens)
        ck = self._ckpt.get(req.rid)
        if ck is not None:
            del req.out_tokens[ck.out_len:]
            req.saved_key = None if ck.key is None else ck.key.copy()
            req.saved_state = ck.state
        else:
            req.out_tokens.clear()
            req.saved_key = None
            req.saved_state = None
        req.fp_memo = None
        self.recompute_tokens += n_out - len(req.out_tokens)

    def _place(self, req: Request, mid_flight: bool,
               resurrect: bool = False) -> bool:
        """Find a surviving home for a stranded request.  Mid-flight
        requests bypass ``max_queue`` (tokens are owed to a client) but
        still need ``engine.feasible``; never-admitted backlog respects
        admission control, exactly as migration does.  Returns False and
        parks the request when nowhere fits (retried every tick)."""
        def has_room(t: _Routable) -> bool:
            mq = t.engine.scheduler.config.max_queue
            return mq is None or t.engine.scheduler.depth < mq

        dst = next(
            (t for t in self._route_order()
             if t.engine.feasible(req) and (mid_flight or has_room(t))),
            None)
        if dst is None:
            self._parked.append((req, mid_flight, resurrect))
            if req.rid not in self._parked_rids:
                self._parked_rids.add(req.rid)
                self.failure_log.append(
                    (self.sim_t, "parked", f"rid={req.rid}"))
            return False
        self._parked_rids.discard(req.rid)
        if mid_flight:
            if req.saved_state is None:
                # recompute estimate: the context re-prefill the survivor
                # pays, minus what its prefix cache already holds
                toks = _cache_tokens_of(req)
                backend = getattr(dst.engine, "backend", None)
                cached = (backend.cached_prefix_tokens(toks)
                          if backend is not None and toks is not None else 0)
                self.recompute_tokens += max(_ctx_len_of(req) - cached, 0)
            self._migrated_rids.add(req.rid)
        if resurrect:
            self.resurrections += 1
            self.failure_log.append(
                (self.sim_t, "resurrect", f"rid={req.rid}->{dst.name}"))
        elif not mid_flight:
            self.queue_moves += 1
        dst.engine.inject(req, force=True)
        return True

    def _checkpoint_lanes(self) -> None:
        """Periodic lightweight lane checkpoints: per occupied lane, the
        generated-token count, a copy of the sampler PRNG counter, and
        the backend snapshot (free constant-size state on recurrent
        backends; ``None`` on dense/paged, whose KV dies with the
        device).  Host-side only — this is what resurrection runs on."""
        if self.sim_t < self._next_ckpt_s:
            return
        self._next_ckpt_s = self.sim_t + self.failover.checkpoint_every_s
        for u in (*self.workers, *self.groups, *self.spec_pairs):
            if self._is_down(u.name):
                continue
            eng = u.engine
            backend = getattr(eng, "backend", None)
            for slot in range(eng.max_batch):
                req = eng.slots[slot]
                if req is None:
                    continue
                state = backend.snapshot(slot) if backend is not None \
                    else None
                self._ckpt[req.rid] = LaneCheckpoint(
                    rid=req.rid, out_len=len(req.out_tokens),
                    key=eng.lane_sampling.key[slot].copy(), state=state,
                    t_s=self.sim_t)
                self.checkpoints += 1

    def _retry_parked(self) -> None:
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        for req, mid, res in parked:
            self._place(req, mid, res)

    # ------------------------------------------------------------------
    # elastic actions
    # ------------------------------------------------------------------
    def drain(self, name: str) -> None:
        """Route new admissions away from ``name`` (its queue still drains
        through it, and its active lanes keep decoding)."""
        w = self._by_name[name]
        if not w.drained:
            w.drained = True
            self.drains += 1

    def undrain(self, name: str) -> None:
        w = self._by_name[name]
        if w.drained:
            w.drained = False
            self.undrains += 1

    def migrate(self, name: str, queued: bool = True,
                lanes: Optional[int] = None) -> int:
        """Move ``name``'s decode lanes (and optionally its queued backlog)
        to the best other workers.  Token-identity is the engine's
        preempt/resume contract; the move count is returned.

        Victim choice is COST-AWARE: lanes are moved cheapest-first by
        ``engine.lane_cost(slot)`` — zero recompute (snapshot-restoring
        backends) before recompute, less re-prefill work before more, and
        the larger memory footprint first within a class (moving it
        relieves the hot worker most per recompute token paid).
        ``lanes`` bounds how many lanes move (None = all) — the policy's
        partial-migration knob, instead of always evicting everything.

        A destination must pass ``engine.feasible(req)`` — a mid-flight
        request moved onto a worker whose backend can never hold its
        final footprint would be REJECTED there, i.e. silently dropped.
        Mid-flight requests (tokens already owed to a client) may bypass
        the destination's ``max_queue``; never-admitted queued backlog
        may not — admission control survives migration.  A lane with no
        acceptable destination is NOT preempted: it keeps decoding (and
        its cache state) on ``name`` rather than paying a re-prefill to
        go nowhere."""
        src = self._by_name[name]
        targets = self._route_order(exclude=src)
        if not targets or all(t.drained for t in targets):
            return 0

        def has_room(t: _Routable) -> bool:
            mq = t.engine.scheduler.config.max_queue
            return mq is None or t.engine.scheduler.depth < mq

        def dest_for(req, mid_flight: bool) -> Optional[_Routable]:
            return next(
                (t for t in self._route_order(exclude=src)
                 if t.engine.feasible(req) and (mid_flight or has_room(t))),
                None)

        moved = 0
        cost = {i: src.engine.lane_cost(i)
                for i, r in enumerate(src.engine.slots) if r is not None}
        occupied = sorted(cost, key=lambda i: (cost[i][0], -cost[i][1]))
        if lanes is not None:
            occupied = occupied[:max(lanes, 0)]
        for slot in occupied:
            # pick the destination BEFORE preempting: evicting a lane
            # that has nowhere to go would throw away its cache state
            # (and pay a re-prefill) just to put it back in line here
            dst = dest_for(src.engine.slots[slot], mid_flight=True)
            if dst is None:
                continue
            req = src.engine.preempt(slot, requeue=False)
            dst.engine.inject(req, force=True)
            self._migrated_rids.add(req.rid)
            self.migrations += 1
            moved += 1
        if queued:
            stay = []
            for req in src.engine.pull_queued():
                mid_flight = req.admitted_t is not None
                dst = dest_for(req, mid_flight)
                if dst is None:
                    stay.append(req)
                    continue
                # room/feasibility verified above; force skips the push
                # path so the probe can't record a spurious rejection
                dst.engine.inject(req, force=True)
                if mid_flight:
                    # a preempted-then-requeued request moved here will
                    # resume cross-engine: that IS a migration
                    self._migrated_rids.add(req.rid)
                self.queue_moves += 1
                moved += 1
            for req in stay:
                src.engine.inject(req, force=True)
        return moved

    def rebalance(self, group_name: str) -> bool:
        """Re-cut a stage group's split from its members' LIVE derated
        rates (the §5.2 rebalance mitigation, serving edition).  The
        engine preempts every lane into its own queue — they re-admit
        token-identically through the new stages via the same
        preempt/inject machinery migration uses — and the layer params
        that changed stage are charged over the link before decode
        resumes.  Returns True if the cut actually changed."""
        g = self.group(group_name)
        derated = [m.spec.profile.derate(m.slowdown) for m in g.members]
        plan = split_decode(g.costs, derated, stage_fixed_mem=g.fixed_mem)
        if not plan.feasible or plan.cuts == g.engine.cuts:
            return False
        old = g.engine.cuts
        moved = g.engine.recut(plan.cuts)
        g._set_rates()
        if moved:
            g.recut_bytes += moved
            # weights cross the slowest boundary link before decode resumes
            g.pending.appendleft(
                _Charge("link", 0, moved / min(g.link_bw)))
        g.recuts += 1
        self.recuts += 1
        self.action_log.append((self.sim_t, Action(
            "rebalance", group_name,
            {"cuts": list(plan.cuts), "prev": list(old),
             "moved_bytes": moved})))
        return True

    def _apply_member(self, g: _GroupRuntime, a: Action) -> None:
        """Policy actions name WORKERS; for a stage-group member they act
        on the group: duty stays per-member (duty-cycling one stage paces
        the whole pipeline through its charges), drain/undrain drain the
        group's admissions, and migrate becomes REBALANCE — a split
        group's lanes cannot leave half their layers behind, but the cut
        can move off the throttled stage."""
        if a.kind == "duty_cycle":
            next(m for m in g.members
                 if m.name == a.worker).duty = a.detail["duty"]
        elif a.kind == "drain":
            self.drain(g.name)
        elif a.kind == "undrain":
            # only undrain once EVERY member recovered: the group is as
            # hot as its hottest stage
            if all(self._state_rank(m.name) == 0 for m in g.members):
                self.undrain(g.name)
        elif a.kind == "migrate":
            self.rebalance(g.name)

    def _apply_spec_member(self, s: _SpecRuntime, a: Action) -> None:
        """Policy actions on a spec-pair member act on the pair: duty
        stays per-member, drain/undrain drain the pair's admissions, and
        migrate splits by role — a hot DRAFT member COLOCATES (drafting
        falls back onto the target, so the phone can cool while the pair
        keeps its speculative speedup mechanics), while a hot TARGET
        member drains the pair (the target holds the lanes and the full
        params; verify has nowhere cheaper to go).  Undrain — gated on
        EVERY member cooling — re-splits a colocated pair."""
        if a.kind == "duty_cycle":
            next(m for m in s.members
                 if m.name == a.worker).duty = a.detail["duty"]
        elif a.kind == "drain":
            self.drain(s.name)
        elif a.kind == "undrain":
            if all(self._state_rank(m.name) == 0 for m in s.members):
                self.undrain(s.name)
                s.set_colocated(False)
        elif a.kind == "migrate":
            if a.worker == s.members[0].name:
                s.set_colocated(True)
            else:
                self.drain(s.name)

    def _apply(self, actions: Sequence[Action]) -> None:
        for a in actions:
            if a.worker in self._member_group:
                self.action_log.append((self.sim_t, a))
                self._apply_member(self._member_group[a.worker], a)
                continue
            if a.worker in self._member_spec:
                self.action_log.append((self.sim_t, a))
                self._apply_spec_member(self._member_spec[a.worker], a)
                continue
            if a.worker not in self._by_name:
                # a shared ThermalMonitor may track non-fleet workers
                # (another fleet, the training pipeline); not ours to act on
                continue
            self.action_log.append((self.sim_t, a))
            if a.kind == "duty_cycle":
                self._by_name[a.worker].duty = a.detail["duty"]
            elif a.kind == "drain":
                self.drain(a.worker)
            elif a.kind == "undrain":
                self.undrain(a.worker)
            elif a.kind == "migrate":
                self.migrate(a.worker, queued=a.detail.get("queued", True),
                             lanes=a.detail.get("lanes"))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def snapshot(self) -> FleetSnapshot:
        occ = self.monitor.occupancy()
        per_worker: Dict[str, WorkerSnapshot] = {}
        sim = max(self.sim_t, 1e-12)
        for w in self.workers:
            ws = self.monitor.workers.get(w.name)
            per_worker[w.name] = WorkerSnapshot(
                name=w.name,
                profile=w.spec.profile.name,
                engine=w.engine.metrics_snapshot(),
                completed=w.done_count,
                completed_tokens=w.done_tokens,
                goodput_tokens_per_s=w.done_tokens / sim,
                steps_run=w.steps_run,
                duty=w.duty,
                drained=w.drained,
                thermal_state=(ws.state.value if ws
                               else ThermalState.MINIMAL.value),
                slowdown=w.slowdown,
                state_occupancy=occ.get(w.name, {}),
                probes=w.probes,
            )
        per_group: Dict[str, GroupSnapshot] = {}
        for g in self.groups:
            members = {}
            for m in g.members:
                ws = self.monitor.workers.get(m.name)
                members[m.name] = {
                    "profile": m.spec.profile.name,
                    "duty": m.duty,
                    "slowdown": m.slowdown,
                    "util": m.util,
                    "probes": m.probes,
                    "thermal_state": (ws.state.value if ws
                                      else ThermalState.MINIMAL.value),
                    "state_occupancy": occ.get(m.name, {}),
                }
            per_group[g.name] = GroupSnapshot(
                name=g.name,
                workers=tuple(m.name for m in g.members),
                cuts=g.engine.cuts,
                engine=g.engine.metrics_snapshot(),
                completed=g.done_count,
                completed_tokens=g.done_tokens,
                goodput_tokens_per_s=g.done_tokens / sim,
                steps_run=g.steps_run,
                drained=g.drained,
                recuts=g.recuts,
                frames_sent=g.engine.frames_sent,
                frame_bytes=g.frame_bytes,
                recut_bytes=g.recut_bytes,
                transfer_s=g.transfer_s,
                link_stall_ticks=g.link_stall_ticks,
                members=members,
            )
        per_spec: Dict[str, SpecSnapshot] = {}
        for s in self.spec_pairs:
            members = {}
            for m in s.members:
                ws = self.monitor.workers.get(m.name)
                members[m.name] = {
                    "profile": m.spec.profile.name,
                    "duty": m.duty,
                    "slowdown": m.slowdown,
                    "util": m.util,
                    "probes": m.probes,
                    "thermal_state": (ws.state.value if ws
                                      else ThermalState.MINIMAL.value),
                    "state_occupancy": occ.get(m.name, {}),
                }
            per_spec[s.name] = SpecSnapshot(
                name=s.name,
                workers=(s.members[0].name, s.members[1].name),
                spec_k=s.spec.spec_k,
                draft_share=s.draft_share,
                engine=s.engine.metrics_snapshot(),
                completed=s.done_count,
                completed_tokens=s.done_tokens,
                goodput_tokens_per_s=s.done_tokens / sim,
                rounds_run=s.steps_run,
                drained=s.drained,
                colocated=s.engine.colocated,
                colocations=s.colocations,
                frame_bytes=s.frame_bytes,
                transfer_s=s.transfer_s,
                link_stall_ticks=s.link_stall_ticks,
                members=members,
            )
        total_tokens = self.completed_tokens
        units: List[_Routable] = [*self.workers, *self.groups,
                                  *self.spec_pairs]
        return FleetSnapshot(
            sim_t=self.sim_t,
            ticks=self.ticks,
            completed=len(self.completed),
            completed_tokens=total_tokens,
            goodput_tokens_per_s=total_tokens / sim,
            migrations=self.migrations,
            migrated_requests=len(self._migrated_rids),
            queue_moves=self.queue_moves,
            drains=self.drains,
            undrains=self.undrains,
            rejected=self.routing_rejected
            + sum(u.engine.scheduler.rejected_total for u in units),
            expired=sum(u.engine.scheduler.expired_total for u in units),
            per_worker=per_worker,
            per_group=per_group,
            per_spec=per_spec,
            recuts=self.recuts,
            probes=sum(w.probes for w in self.workers)
            + sum(m.probes for g in self.groups for m in g.members)
            + sum(m.probes for s in self.spec_pairs for m in s.members),
            transfer_bytes=sum(g.frame_bytes + g.recut_bytes
                               for g in self.groups)
            + sum(s.frame_bytes for s in self.spec_pairs),
            transfer_s=sum(g.transfer_s for g in self.groups)
            + sum(s.transfer_s for s in self.spec_pairs),
            deaths=self.deaths,
            resurrections=self.resurrections,
            recompute_tokens=self.recompute_tokens,
            orphaned=len(self._parked),
            checkpoints=self.checkpoints,
            dead_units=tuple(sorted(self._dead)),
        )


def drive_sim(fleet: ServingFleet, arrival_times: Sequence[float],
              submit, max_ticks: int = 1_000_000) -> float:
    """Open-loop driving in SIMULATED time: ``submit(i)`` is called when
    arrival ``i`` comes due on the fleet's sim clock, and the fleet ticks
    until every arrival is submitted and drained.  The sim-clock analogue
    of :func:`repro_torch.serving.traffic.drive_open_loop` — shared so benches,
    demos and tests cannot drift apart on drive semantics.  Returns the
    simulated seconds elapsed."""
    t0 = fleet.sim_t
    n, i = len(arrival_times), 0
    for _ in range(max_ticks):
        while i < n and arrival_times[i] <= fleet.sim_t - t0:
            submit(i)
            i += 1
        if i >= n and fleet.idle():
            break
        fleet.tick()
    else:
        warnings.warn(
            f"drive_sim exhausted max_ticks={max_ticks} with work "
            f"outstanding ({len(fleet.completed)} finished)",
            RuntimeWarning, stacklevel=2)
    return fleet.sim_t - t0
