"""Scale plane: a vectorized fleet simulator for production-size benches
(a copy of ``repro/serving/scale.py``).

``ServingFleet`` (the reference's ``repro/serving/fleet.py``; the port's is
ROADMAP item 6c) paces *real* engines in
simulated time — perfect for token-identity claims, useless at the
ROADMAP's "heavy traffic from millions of users" scale: every tick walks
Python loops over workers, lanes and charge queues, and every worker runs
real forward passes.  :class:`SimFleet` keeps the fleet's capacity
semantics (device serving rates, thermal reservoirs, duty/drain policy,
probe pacing, routing score shape) and drops the model math, so hundreds
of workers and tens of thousands of requests simulate in CI seconds.

Two interchangeable tick implementations:

* ``impl="loop"`` — the pre-refactor idiom: per-worker, per-step, per-lane
  Python loops, one token decrement at a time (how ServingFleet's tick is
  structured today).
* ``impl="vector"`` — numpy structure-of-arrays bookkeeping: worker state
  lives in flat float/int arrays, decode grants are closed-form
  (``min(floor(credit/step_cost), max lane need)`` per row), probes are
  batched mask updates.

Both produce **bit-identical** results (same float expression trees, same
event ordering), so the loop baseline is an honest yardstick for the
micro-bench's >=10x tick-throughput gate and a semantic oracle in tests.

On top of the tick core the SimFleet adds the production-scale control
surface the real fleet doesn't have yet:

* **admission control** — reject-at-submit when even the best worker's
  *predicted* TTFT (queued prefill + decode backlog, derated by thermal
  slowdown and duty) would blow the request's deadline (or its SLO class
  TTFT target).  Shed is counted separately from capacity rejects.
* **autoscaling** — an :class:`repro_torch.runtime.elastic.AutoscalePolicy`
  consumes a :class:`~repro_torch.runtime.elastic.FleetLoad` reading each tick;
  scale-up brings spare rows up with params charged over the link as
  warm-up seconds before they serve, scale-down drains a worker's lanes
  and queue then retires it.
* **failure plane** — a seeded :class:`repro_torch.runtime.faults.KillTrace`
  marks rows dead mid-run (crash / partition / zombie).  Dead rows stop
  earning credit immediately; after ``detect_s`` the fleet strands their
  lanes and queue onto survivors.  Lane checkpoints (a ``lane_rem``
  snapshot every ``ckpt_every_s``) bound the redo: a stranded lane
  resumes from its checkpoint, charging only the tokens decoded since
  plus a re-prefill of the prompt to ``recompute_tokens``.  Partitions
  that heal before detection are transparent blips; zombies return cold
  (heat, credit and warm-up reset).  All fault phases are shared code,
  so ``impl="loop"`` and ``impl="vector"`` stay bit-identical under
  kills.
* **training plane** — with ``fed=FedSimConfig(...)`` the fleet mirrors
  ``FedRoundCoordinator`` (``repro/serving/train_plane.py``) at capacity
  level: federated rounds pay cold training seconds out of the same
  per-tick credit decode spends (serving-idle, thermally-eligible rows
  only; preemption counted), ship one update frame per participant over
  the row's link, heat the thermal reservoir like any busy time, and
  compose with the failure plane (a detected-dead participant is
  excluded from its round).  The fed phase is shared code, so loop and
  vector stay bit-identical with training on.

``SimFleet`` duck-types the fleet's ``drive_sim`` (``sim_t`` /
``tick`` / ``idle`` / ``completed``), and :func:`play` drives a
:class:`~repro_torch.serving.traffic.TrafficTrace` end-to-end without any model or
engine at all.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.hw.specs import DeviceProfile
from repro_torch.runtime.elastic import AutoscalePolicy, FleetLoad
from repro_torch.runtime.faults import KillTrace
from repro_torch.runtime.monitor import THRESHOLDS
from repro_torch.serving.metrics import (OUTCOME_DONE, OUTCOME_EXPIRED,
                                   OUTCOME_REJECTED, OUTCOME_SHED, SLOClass,
                                   SLOReport, slo_report)

# slowdown thresholds for MINIMAL/FAIR/SERIOUS/CRITICAL ranks (0..3),
# shared with the real fleet's ThermalMonitor state machine
_RANK_EDGES = np.array([thr for thr in THRESHOLDS.values()][1:],
                       dtype=np.float64)

# non-terminal request states (terminal ones are the metrics OUTCOME_* ids)
_QUEUED = -1
_ACTIVE = -2


@dataclasses.dataclass(frozen=True)
class ScaleWorkerSpec:
    """Template for one SimFleet row: a replica worker, or — with
    ``n_members > 1`` — a pipeline-split StageGroup modelled at capacity
    level (members contribute their slice of each pass; boundary
    activations cost ``frame_bytes`` over the profile's link per hop)."""
    profile: DeviceProfile
    max_batch: int = 8
    max_queue: int = 64
    n_members: int = 1
    frame_bytes: int = 4096

    def decode_rate(self) -> float:
        """Effective batched decode steps/s of the unit."""
        step_s = 1.0 / self.profile.decode_rate()
        if self.n_members > 1:
            step_s += ((self.n_members - 1) * self.frame_bytes
                       / self.profile.link_bw)
        return 1.0 / step_s

    def prefill_rate(self) -> float:
        return self.profile.prefill_rate()

    def warm_s(self, param_bytes: float) -> float:
        """Seconds to stream ``param_bytes`` of params over the link before
        this row can serve; a split group ships its slices in parallel."""
        if param_bytes <= 0:
            return 0.0
        return param_bytes / max(self.n_members, 1) / self.profile.link_bw


def make_rows(spec: ScaleWorkerSpec, n: int) -> List[ScaleWorkerSpec]:
    """``n`` identical rows (the common homogeneous-pool case)."""
    return [spec] * n


@dataclasses.dataclass(frozen=True)
class FedSimConfig:
    """Capacity-level mirror of the training plane
    (``repro/serving/train_plane.py``) for the model-free SimFleet: rounds
    of per-participant training compute charged from the SAME per-tick
    credit decode spends — only in serving-idle, thermally-eligible ticks
    — plus one update frame per participant charged over the link.  No
    model math runs; the mirror keeps the *scheduling* semantics so the
    serve-while-train SLO A/B gates at production scale."""
    rounds: int = 4
    participants: int = 2
    local_steps: int = 2
    step_tokens: int = 128          # batch * seq_len per local step
    flops_mult: float = 3.0         # fwd+bwd+update cost vs one forward
    frame_bytes: int = 1 << 16      # encoded update frame size
    max_rank: int = 2               # preempt at SERIOUS or worse
    round_timeout_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class ScaleSnapshot:
    """One frozen reading of a SimFleet run.  Everything is hashable /
    equality-comparable, so determinism tests can assert two seeded runs
    (or the loop and vector implementations) produced the *same* snapshot."""
    sim_t: float
    ticks: int
    offered: int
    completed: int
    completed_tokens: int
    goodput_tokens_per_s: float
    shed: int                 # admission-control rejects (predicted TTFT miss)
    rejected: int             # capacity rejects (every eligible queue full)
    expired: int              # deadline passed while queued
    queued_now: int
    active_now: int
    serving_now: int
    peak_serving: int
    scale_ups: int            # scale-up events (rows brought up)
    scale_downs: int          # scale-down events (rows sent to retire)
    retired: int              # rows fully drained and dropped
    warm_bytes_total: float   # param bytes charged over links by scale-ups
    warm_link_s_total: float  # link-seconds those transfers cost
    probes: int
    drains: int
    undrains: int
    heat_max: float
    slo: SLOReport
    events: Tuple[Tuple[float, str, int], ...]
    serving_series: Tuple[int, ...]   # serving-worker count per tick
    deaths: int = 0               # rows declared dead after detect_s
    resurrections: int = 0        # stranded lanes resumed on survivors
    recompute_tokens: int = 0     # redone decode + re-prefill after deaths
    orphaned: int = 0             # stranded rids still awaiting a survivor
    fed_rounds: int = 0           # completed training rounds (fed mirror)
    fed_deliveries: int = 0       # participant legs delivered
    fed_excluded: int = 0         # legs excluded (death / round deadline)
    fed_samples: int = 0          # local steps behind applied updates
    fed_train_s: float = 0.0      # credit seconds spent on training
    fed_wire_bytes: int = 0       # update frame bytes charged on links
    fed_preempt_ticks: int = 0    # participant-ticks preempted by serving

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SimFleet:
    """Hundreds of simulated serving workers in structure-of-arrays form.

    ``rows`` declares the scalable pool (one :class:`ScaleWorkerSpec` per
    potential worker); the first ``n_start`` rows begin alive, the rest are
    spare capacity only an :class:`AutoscalePolicy` can bring up.  See the
    module docstring for the semantics; all per-row state is public numpy
    arrays (``heat``, ``duty``, ``drained``, ``queue_len``, ...) so tests
    can stage scenarios directly.
    """

    def __init__(self, rows: Sequence[ScaleWorkerSpec], *,
                 n_start: Optional[int] = None,
                 tick_s: float = 0.05,
                 slo: Sequence[SLOClass] = (SLOClass("default"),),
                 admission: bool = True,
                 admission_safety: float = 1.0,
                 autoscaler: Optional[AutoscalePolicy] = None,
                 autoscale_every_s: float = 1.0,
                 elastic: bool = True,
                 fair_duty: float = 0.85,
                 serious_duty: float = 0.6,
                 drain_rank: int = 2,
                 thermal_routing: bool = True,
                 cool_frac: float = 0.5,
                 probe_every_s: float = 0.25,
                 warm_param_bytes: float = 0.0,
                 kill_trace: Optional[KillTrace] = None,
                 detect_s: float = 0.5,
                 ckpt_every_s: float = 0.5,
                 fed: Optional[FedSimConfig] = None,
                 impl: str = "vector"):
        if impl not in ("vector", "loop"):
            raise ValueError(f"impl must be 'vector' or 'loop', got {impl!r}")
        if not rows:
            raise ValueError("need at least one worker row")
        self.impl = impl
        self.n = len(rows)
        self.rows = tuple(rows)
        self.tick_s = float(tick_s)
        self.slo = tuple(slo)
        self.admission = admission
        self.admission_safety = float(admission_safety)
        self.autoscaler = autoscaler
        self.autoscale_every_s = float(autoscale_every_s)
        self.elastic = elastic
        self.fair_duty = float(fair_duty)
        self.serious_duty = float(serious_duty)
        self.drain_rank = int(drain_rank)
        self.thermal_routing = thermal_routing
        self.cool_frac = float(cool_frac)
        self.probe_every_s = float(probe_every_s)
        self.warm_param_bytes = float(warm_param_bytes)
        self.kill_trace = kill_trace
        self.detect_s = float(detect_s)
        self.ckpt_every_s = float(ckpt_every_s)

        n = self.n
        f64 = np.float64
        # immutable per-row ratings
        self.decode_rate_arr = np.array([r.decode_rate() for r in rows], f64)
        self.prefill_rate_arr = np.array([r.prefill_rate() for r in rows], f64)
        self.max_batch_arr = np.array([r.max_batch for r in rows], np.int64)
        self.max_queue_arr = np.array([r.max_queue for r in rows], np.int64)
        self.s_gain = np.array(
            [1.0 / r.profile.thermal_sustained - 1.0 for r in rows], f64)
        # bankable compute credit: two ticks, but never less than one decode
        # step at worst-case slowdown — a row whose step spans multiple
        # ticks must be able to save up for it or it deadlocks at 0 steps
        self._cap_s = np.maximum(2.0 * self.tick_s,
                                 (1.0 + self.s_gain) / self.decode_rate_arr)
        self.t_tau = np.array([r.profile.thermal_tau_s for r in rows], f64)
        self.warm_s_arr = np.array(
            [r.warm_s(self.warm_param_bytes) for r in rows], f64)
        self.link_bw_arr = np.array([r.profile.link_bw for r in rows], f64)
        self.lmax = int(self.max_batch_arr.max())

        # mutable worker state (SoA)
        if n_start is None:
            n_start = n
        if not 1 <= n_start <= n:
            raise ValueError("need 1 <= n_start <= len(rows)")
        self.alive = np.zeros(n, bool)
        self.alive[:n_start] = True
        self.retiring = np.zeros(n, bool)
        self.drained = np.zeros(n, bool)
        # dead rows keep alive=True (a crashed worker is NOT spare capacity
        # for _scale_up) but are masked out of earning/serving/routing
        self.dead = np.zeros(n, bool)
        self.warm_rem = np.zeros(n, f64)   # rows start warm; scale-ups don't
        self.duty = np.ones(n, f64)
        self.heat = np.zeros(n, f64)
        self.slowdown = np.ones(n, f64)
        self.credit = np.zeros(n, f64)
        self.util = np.zeros(n, f64)
        self.queue_len = np.zeros(n, np.int64)
        self.active_lanes = np.zeros(n, np.int64)
        self.pending_prefill = np.zeros(n, np.int64)  # queued prompt tokens
        self.pending_steps = np.zeros(n, np.int64)    # queued+active out tokens
        self.next_probe = np.zeros(n, f64)
        self.probes_arr = np.zeros(n, np.int64)
        self.lane_req = np.full((n, self.lmax), -1, np.int64)
        self.lane_rem = np.zeros((n, self.lmax), np.int64)
        self.queues: List[Deque[int]] = [deque() for _ in range(n)]
        self._earning = self.alive & (self.warm_rem <= 0.0) & ~self.dead
        self._prefill_spent = np.zeros(n, f64)
        self._has_deadlines = False

        # failure plane: checkpointed lane_rem, kill schedule, resume state
        self.lane_ckpt = np.zeros((n, self.lmax), np.int64)
        self._kill_events = list(kill_trace) if kill_trace is not None else []
        self._next_kill = 0
        self._detect_at: Dict[int, float] = {}
        self._return_at: Dict[int, Tuple[float, str]] = {}
        self._resume_rem: Dict[int, int] = {}
        self._strand_retry: Deque[Tuple[int, bool]] = deque()
        self._next_ckpt = self.ckpt_every_s
        self.deaths = 0
        self.resurrections = 0
        self.recompute_tokens = 0

        # training-plane mirror (shared-phase code: loop == vector)
        self.fed = fed
        self._fed_members: List[int] = []
        self._fed_comp: Dict[int, float] = {}   # cold compute s remaining
        self._fed_link: Dict[int, float] = {}   # wire s remaining
        self._fed_done: set = set()
        self._fed_failed: set = set()
        self._fed_deadline = math.inf
        self.fed_rounds = 0
        self.fed_deliveries = 0
        self.fed_excluded = 0
        self.fed_samples = 0
        self.fed_train_s = 0.0
        self.fed_wire_bytes = 0
        self.fed_preempt_ticks = 0

        # per-request records (parallel lists, index = rid)
        self.q_submit: List[float] = []
        self.q_first: List[float] = []
        self.q_done: List[float] = []
        self.q_prompt: List[int] = []
        self.q_max_new: List[int] = []
        self.q_class: List[int] = []
        self.q_deadline: List[Optional[float]] = []
        self.q_status: List[int] = []
        self.q_worker: List[int] = []

        # clocks + counters
        self.sim_t = 0.0
        self.ticks = 0
        self.offered = 0
        self.n_done = 0
        self.completed_tokens = 0
        self.generated_tokens = 0
        self.shed = 0
        self.rejected = 0
        self.expired = 0
        self.steps_run = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.retired = 0
        self.warm_bytes_total = 0.0
        self.warm_link_s_total = 0.0
        self.drains = 0
        self.undrains = 0
        self.peak_serving = int(n_start)
        self.events: List[Tuple[float, str, int]] = []
        self.serving_series: List[int] = []
        self._next_autoscale = 0.0

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------
    @property
    def completed(self) -> List[int]:
        """Rids of completed requests (drive_sim duck-typing)."""
        return [rid for rid, st in enumerate(self.q_status)
                if st == OUTCOME_DONE]

    def idle(self) -> bool:
        # an active training round must resolve (deliver or deadline-fail)
        # before the fleet reads as idle — play() never cuts a round short
        return (int(self.queue_len.sum()) == 0
                and int(self.active_lanes.sum()) == 0
                and not self._strand_retry
                and not self._fed_members)

    def _serving_mask(self) -> np.ndarray:
        return (self.alive & (self.warm_rem <= 0.0) & ~self.retiring
                & ~self.dead)

    def _ranks(self) -> np.ndarray:
        """Thermal rank per row: 0 MINIMAL, 1 FAIR, 2 SERIOUS, 3 CRITICAL
        (same slowdown thresholds as the ThermalMonitor state machine)."""
        return np.searchsorted(_RANK_EDGES, self.slowdown, side="right")

    def _est_wait(self, idx: np.ndarray) -> np.ndarray:
        """Predicted seconds until a new admission would see its first
        token on each row: queued prefill + decode backlog, derated by the
        row's thermal slowdown and duty cycle."""
        sd = self.slowdown[idx]
        duty = np.maximum(self.duty[idx], 1e-3)
        pre = self.pending_prefill[idx] * sd / self.prefill_rate_arr[idx]
        dec = (self.pending_steps[idx] / self.max_batch_arr[idx]
               * sd / self.decode_rate_arr[idx])
        return (pre + dec) / duty

    def load(self) -> FleetLoad:
        """The aggregate reading an :class:`AutoscalePolicy` scales on."""
        serving = self._serving_mask()
        idx = np.flatnonzero(serving)
        wait = self._est_wait(idx) if len(idx) else np.zeros(0)
        ranks = self._ranks()[idx]
        return FleetLoad(
            sim_t=self.sim_t,
            serving=int(serving.sum()),
            warming=int((self.alive & (self.warm_rem > 0.0)
                         & ~self.dead).sum()),
            spare=int((~self.alive & ~self.retiring).sum()),
            queue_depth=int(self.queue_len[idx].sum()) if len(idx) else 0,
            backlog_s=float(wait.mean()) if len(idx) else 0.0,
            backlog_max_s=float(wait.max()) if len(idx) else 0.0,
            hot_frac=float((ranks >= 2).mean()) if len(idx) else 0.0,
            util_mean=float(self.util[idx].mean()) if len(idx) else 0.0)

    # ------------------------------------------------------------------
    # submission: routing, admission control, capacity rejects
    # ------------------------------------------------------------------
    def submit(self, prompt_len: int, max_new: int = 16, *,
               class_id: int = 0, deadline_s: Optional[float] = None
               ) -> Optional[int]:
        """Route one request; returns its rid, or None when shed by
        admission control or rejected for capacity (recorded either way)."""
        if not 0 <= class_id < len(self.slo):
            raise ValueError(f"unknown SLO class {class_id}")
        rid = len(self.q_status)
        self.q_submit.append(self.sim_t)
        self.q_first.append(float("nan"))
        self.q_done.append(float("nan"))
        self.q_prompt.append(int(prompt_len))
        self.q_max_new.append(int(max_new))
        self.q_class.append(int(class_id))
        self.q_deadline.append(deadline_s)
        self.q_worker.append(-1)
        self.offered += 1
        if deadline_s is not None:
            self._has_deadlines = True

        warm = self.alive & (self.warm_rem <= 0.0) & ~self.dead
        room = self.queue_len < self.max_queue_arr
        open_ = warm & ~self.drained & ~self.retiring & room
        if not open_.any():
            # all-drained fallback: queue rather than vanish (matches
            # ServingFleet's routing), but never onto a retiring worker
            open_ = warm & ~self.retiring & room
        if not open_.any():
            self.q_status.append(OUTCOME_REJECTED)
            self.rejected += 1
            return None
        idx = np.flatnonzero(open_)
        pred = (self._est_wait(idx)
                + prompt_len * self.slowdown[idx] / self.prefill_rate_arr[idx])
        if self.admission:
            limit = deadline_s if deadline_s is not None \
                else self.slo[class_id].ttft_s
            if (limit is not None and np.isfinite(limit)
                    and float(pred.min()) > limit * self.admission_safety):
                self.q_status.append(OUTCOME_SHED)
                self.shed += 1
                return None
        rank = (self._ranks()[idx] if self.thermal_routing
                else np.zeros(len(idx), np.int64))
        # routing score, least-loaded-coolest-first; same shape as the real
        # fleet's _route_order: (thermal rank, backlog, tiebreak by index)
        best = int(idx[np.lexsort((idx, self.queue_len[idx], pred, rank))[0]])
        self.q_status.append(_QUEUED)
        self.q_worker[rid] = best
        self.queues[best].append(rid)
        self.queue_len[best] += 1
        self.pending_prefill[best] += int(prompt_len)
        self.pending_steps[best] += int(max_new)
        return rid

    # ------------------------------------------------------------------
    # request terminal transitions
    # ------------------------------------------------------------------
    def _rem_total(self, rid: int) -> int:
        """Output tokens this rid still owes: its checkpointed remainder
        when resuming after a death, its full budget otherwise."""
        return self._resume_rem.get(rid, self.q_max_new[rid])

    def _drop_expired(self, w: int, rid: int) -> None:
        self.q_status[rid] = OUTCOME_EXPIRED
        self.q_done[rid] = self.sim_t
        self.expired += 1
        self.queue_len[w] -= 1
        self.pending_prefill[w] -= self.q_prompt[rid]
        self.pending_steps[w] -= self._rem_total(rid)
        self._resume_rem.pop(rid, None)

    def _complete(self, rid: int) -> None:
        self.q_status[rid] = OUTCOME_DONE
        self.q_done[rid] = self.sim_t
        self.n_done += 1
        self.completed_tokens += self.q_max_new[rid]

    def _finish_lane(self, w: int, lane: int) -> None:
        rid = int(self.lane_req[w, lane])
        self.lane_req[w, lane] = -1
        self.active_lanes[w] -= 1
        self._complete(rid)

    def _expired_now(self, rid: int) -> bool:
        dl = self.q_deadline[rid]
        return dl is not None and self.sim_t - self.q_submit[rid] > dl

    # ------------------------------------------------------------------
    # tick phases.  Admission/expiry, policy and autoscale are shared code;
    # the credit/decode/probe/thermal hot path exists twice — see module
    # docstring for the loop-vs-vector contract (bit-identical results).
    # ------------------------------------------------------------------
    def tick(self) -> None:
        self.sim_t += self.tick_s
        self.ticks += 1
        if self.kill_trace is not None:
            self._process_faults()
        if self.impl == "vector":
            self._phase_rates_vector()
        else:
            self._phase_rates_loop()
        self._admit_and_expire()
        if self.impl == "vector":
            self._phase_decode_vector()
        else:
            self._phase_decode_loop()
        if self.fed is not None:
            self._phase_fed()
        if self.kill_trace is not None:
            self._checkpoint_lanes()
        if self.elastic:
            self._apply_elastic()
        if self.autoscaler is not None and self.sim_t >= self._next_autoscale:
            self._next_autoscale = self.sim_t + self.autoscale_every_s
            for act in self.autoscaler.step(self.load()):
                if act.kind == "scale_up":
                    self._scale_up(int(act.detail["n"]))
                elif act.kind == "scale_down":
                    self._scale_down(int(act.detail["n"]))
        self._retire_done()
        serving_now = int(self._serving_mask().sum())
        self.peak_serving = max(self.peak_serving, serving_now)
        self.serving_series.append(serving_now)

    # --- phase A: slowdown, warm-up spend, credit accrual -------------
    def _phase_rates_vector(self) -> None:
        self.slowdown = 1.0 + self.heat * self.s_gain
        spend = np.where(self.alive,
                         np.minimum(self.warm_rem, self.tick_s), 0.0)
        self.warm_rem = self.warm_rem - spend
        self._earning = self.alive & (self.warm_rem <= 0.0) & ~self.dead
        grown = np.minimum(self.credit + self.tick_s * self.duty, self._cap_s)
        self.credit = np.where(self._earning, grown, self.credit)

    def _phase_rates_loop(self) -> None:
        for w in range(self.n):
            self.slowdown[w] = 1.0 + self.heat[w] * self.s_gain[w]
            spend = min(self.warm_rem[w], self.tick_s) if self.alive[w] else 0.0
            self.warm_rem[w] = self.warm_rem[w] - spend
            earning = (bool(self.alive[w]) and self.warm_rem[w] <= 0.0
                       and not bool(self.dead[w]))
            self._earning[w] = earning
            if earning:
                self.credit[w] = min(
                    self.credit[w] + self.tick_s * self.duty[w],
                    self._cap_s[w])

    # --- shared: head expiry + prefill admission ----------------------
    def _admit_and_expire(self) -> None:
        self._prefill_spent[:] = 0.0
        mask = (self.queue_len > 0) & self._earning
        if not self._has_deadlines:
            # nothing can expire, so rows without a free lane and positive
            # credit have no admission work this tick
            mask &= (self.active_lanes < self.max_batch_arr) \
                & (self.credit > 0.0)
        rows = np.flatnonzero(mask)
        for w in rows.tolist():
            q = self.queues[w]
            # expire rotting heads even when no lane or credit is free
            while q and self._expired_now(q[0]):
                self._drop_expired(w, q.popleft())
            while (q and self.active_lanes[w] < self.max_batch_arr[w]
                    and self.credit[w] > 0.0):
                rid = q.popleft()
                if self._expired_now(rid):
                    self._drop_expired(w, rid)
                    continue
                # prefill is charged whole at admission (may push the row
                # into credit debt — a long prompt spans ticks)
                rem_total = self._rem_total(rid)
                self._resume_rem.pop(rid, None)
                cost = (self.q_prompt[rid] * self.slowdown[w]
                        / self.prefill_rate_arr[w])
                self.credit[w] -= cost
                self._prefill_spent[w] += cost
                self.queue_len[w] -= 1
                self.pending_prefill[w] -= self.q_prompt[rid]
                self.pending_steps[w] -= 1          # first token via prefill
                if math.isnan(self.q_first[rid]):
                    self.q_first[rid] = self.sim_t
                self.generated_tokens += 1
                if rem_total <= 1:
                    self._complete(rid)
                    continue
                lane = int(np.flatnonzero(self.lane_req[w] < 0)[0])
                self.lane_req[w, lane] = rid
                self.lane_rem[w, lane] = rem_total - 1
                self.lane_ckpt[w, lane] = rem_total - 1
                self.active_lanes[w] += 1
                self.q_status[rid] = _ACTIVE

    # --- phase B: decode grants, finishes, probes, util, heat ---------
    def _phase_decode_vector(self) -> None:
        step_cost = self.slowdown / self.decode_rate_arr
        can = self._earning & (self.active_lanes > 0) & (self.credit > 0.0)
        ncap = np.where(can, np.floor(self.credit / step_cost),
                        0.0).astype(np.int64)
        occupied = self.lane_req >= 0
        need = np.max(np.where(occupied, self.lane_rem, 0), axis=1)
        nuse = np.minimum(ncap, need)
        granted = np.where(occupied,
                           np.minimum(self.lane_rem, nuse[:, None]), 0)
        self.lane_rem = self.lane_rem - granted
        row_tokens = granted.sum(axis=1)
        self.credit = self.credit - nuse * step_cost
        self.pending_steps = self.pending_steps - row_tokens
        self.generated_tokens += int(row_tokens.sum())
        self.steps_run += int(nuse.sum())
        done_r, done_l = np.nonzero(occupied & (self.lane_rem == 0))
        for w, lane in zip(done_r.tolist(), done_l.tolist()):
            self._finish_lane(w, lane)
        # probe batching: every truly idle worker pays one step_cost per
        # probe window (the real fleet's keep-alive capability probe)
        ran = (nuse > 0) | (self._prefill_spent > 0.0)
        idle = (self._earning & ~ran & (self.active_lanes == 0)
                & (self.queue_len == 0))
        due = idle & (self.sim_t >= self.next_probe)
        self.credit = np.where(due, self.credit - step_cost, self.credit)
        self.probes_arr = self.probes_arr + due
        reset = due | (ran & self._earning)
        self.next_probe = np.where(reset, self.sim_t + self.probe_every_s,
                                   self.next_probe)
        busy = (self._prefill_spent + nuse * step_cost
                + np.where(due, step_cost, 0.0))
        self.util = np.where(self._earning,
                             np.minimum(busy / self.tick_s, 1.0), 0.0)
        dh = self.tick_s * (
            self.util / self.t_tau
            - (1.0 - self.util) * self.heat / (self.t_tau * self.cool_frac))
        heatable = self._earning & np.isfinite(self.t_tau)
        self.heat = np.where(heatable,
                             np.clip(self.heat + dh, 0.0, 1.0), self.heat)

    def _phase_decode_loop(self) -> None:
        for w in range(self.n):
            earning = bool(self._earning[w])
            step_cost = self.slowdown[w] / self.decode_rate_arr[w]
            steps = 0
            tokens = 0
            if earning and self.active_lanes[w] > 0 and self.credit[w] > 0.0:
                ncap = int(np.floor(self.credit[w] / step_cost))
                # the pre-vectorization hot path: one token per lane per
                # step, one step at a time
                while steps < ncap:
                    advanced = 0
                    for lane in range(self.lmax):
                        if (self.lane_req[w, lane] >= 0
                                and self.lane_rem[w, lane] > 0):
                            self.lane_rem[w, lane] -= 1
                            advanced += 1
                    if advanced == 0:
                        break
                    steps += 1
                    tokens += advanced
            self.credit[w] = self.credit[w] - steps * step_cost
            self.pending_steps[w] = self.pending_steps[w] - tokens
            self.generated_tokens += tokens
            self.steps_run += steps
            for lane in range(self.lmax):
                if (self.lane_req[w, lane] >= 0
                        and self.lane_rem[w, lane] == 0):
                    self._finish_lane(w, lane)
            ran = steps > 0 or self._prefill_spent[w] > 0.0
            idle = (earning and not ran and self.active_lanes[w] == 0
                    and self.queue_len[w] == 0)
            due = idle and self.sim_t >= self.next_probe[w]
            if due:
                self.credit[w] = self.credit[w] - step_cost
                self.probes_arr[w] += 1
            if due or (ran and earning):
                self.next_probe[w] = self.sim_t + self.probe_every_s
            busy = (self._prefill_spent[w] + steps * step_cost
                    + (step_cost if due else 0.0))
            self.util[w] = (min(busy / self.tick_s, 1.0) if earning else 0.0)
            if earning and np.isfinite(self.t_tau[w]):
                dh = self.tick_s * (
                    self.util[w] / self.t_tau[w]
                    - (1.0 - self.util[w]) * self.heat[w]
                    / (self.t_tau[w] * self.cool_frac))
                self.heat[w] = min(max(self.heat[w] + dh, 0.0), 1.0)

    # --- shared: duty/drain policy + autoscale execution --------------
    def _apply_elastic(self) -> None:
        ranks = self._ranks()
        duty = np.where(ranks >= 2, self.serious_duty,
                        np.where(ranks >= 1, self.fair_duty, 1.0))
        self.duty = np.where(self.alive, duty, 1.0)
        want = self.alive & (ranks >= self.drain_rank)
        self.drains += int((want & ~self.drained).sum())
        self.drained = self.drained | want
        # hysteresis: undrain only on full recovery to MINIMAL
        recovered = self.drained & (ranks == 0)
        self.undrains += int(recovered.sum())
        self.drained = self.drained & ~recovered

    def _scale_up(self, n: int) -> None:
        spare = np.flatnonzero(~self.alive & ~self.retiring)[:n]
        if len(spare) == 0:
            return
        self.alive[spare] = True
        self.warm_rem[spare] = self.warm_s_arr[spare]
        self.heat[spare] = 0.0
        self.slowdown[spare] = 1.0
        self.credit[spare] = 0.0
        self.duty[spare] = 1.0
        self.drained[spare] = False
        self.next_probe[spare] = self.sim_t + self.probe_every_s
        self.scale_ups += 1
        self.warm_bytes_total += self.warm_param_bytes * len(spare)
        self.warm_link_s_total += float(self.warm_s_arr[spare].sum())
        self.events.append((self.sim_t, "scale_up", int(len(spare))))

    def _scale_down(self, n: int) -> None:
        cand = np.flatnonzero(self._serving_mask())
        if len(cand) <= 1:
            return
        n = min(n, len(cand) - 1)   # never retire the whole fleet
        if n <= 0:
            return
        # retire the emptiest rows first: they drain fastest
        backlog = (self.active_lanes[cand] + self.queue_len[cand])
        order = np.lexsort((cand, self.util[cand], backlog))
        pick = cand[order[:n]]
        self.retiring[pick] = True
        self.scale_downs += 1
        self.events.append((self.sim_t, "scale_down", int(n)))

    def _retire_done(self) -> None:
        # a dead retiring row must not "finish draining" into the spare
        # pool just because its lanes were stranded elsewhere
        done = (self.retiring & ~self.dead & (self.active_lanes == 0)
                & (self.queue_len == 0))
        k = int(done.sum())
        if k:
            self.alive[done] = False
            self.retiring[done] = False
            self.heat[done] = 0.0
            self.credit[done] = 0.0
            self.retired += k

    # --- shared: failure plane (kills, detection, lane resurrection) --
    def _process_faults(self) -> None:
        # returns first, so a partition that heals before its detection
        # deadline cancels the strand — a transparent blip
        for w in [w for w, (t, _) in self._return_at.items()
                  if self.sim_t >= t]:
            _, kind = self._return_at.pop(w)
            self.dead[w] = False
            self._detect_at.pop(w, None)
            if kind == "zombie":
                # cold restart: model state gone, params re-stream
                self.warm_rem[w] = self.warm_s_arr[w]
                self.heat[w] = 0.0
                self.slowdown[w] = 1.0
            self.credit[w] = 0.0
            self.next_probe[w] = self.sim_t + self.probe_every_s
            self.events.append((self.sim_t, "return", int(w)))
        while (self._next_kill < len(self._kill_events)
               and self._kill_events[self._next_kill].t_s <= self.sim_t):
            ev = self._kill_events[self._next_kill]
            self._next_kill += 1
            try:
                w = int(ev.worker)
            except (TypeError, ValueError):
                continue
            if not (0 <= w < self.n) or self.dead[w] or not self.alive[w]:
                continue
            self.dead[w] = True
            self._detect_at[w] = self.sim_t + self.detect_s
            if ev.returns:
                self._return_at[w] = (self.sim_t + ev.down_s, ev.kind)
            self.events.append((self.sim_t, "kill", int(w)))
        for w in [w for w, t in self._detect_at.items() if self.sim_t >= t]:
            self._detect_at.pop(w)
            if self.dead[w]:
                self._strand_row(w)
        # orphans parked when no survivor could take them: retry each tick
        for _ in range(len(self._strand_retry)):
            rid, resurrect = self._strand_retry.popleft()
            if self._expired_now(rid):
                self.q_status[rid] = OUTCOME_EXPIRED
                self.q_done[rid] = self.sim_t
                self.expired += 1
                self._resume_rem.pop(rid, None)
                continue
            self._fo_route(rid, resurrect=resurrect)

    def _strand_row(self, w: int) -> None:
        """Declare row ``w`` dead: roll its active lanes back to their
        checkpoints and re-route them (plus its queue) onto survivors."""
        self.deaths += 1
        self.events.append((self.sim_t, "death", int(w)))
        # a detected-dead participant is excluded from its training round
        # (mirrors the coordinator keying exclusion on fleet._dead)
        if w in self._fed_members and not self._fed_resolved(w):
            self._fed_failed.add(w)
        for lane in range(self.lmax):
            rid = int(self.lane_req[w, lane])
            if rid < 0:
                continue
            ck = int(self.lane_ckpt[w, lane])
            rem = int(self.lane_rem[w, lane])
            # tokens decoded since the checkpoint are redone on the
            # destination, plus a re-prefill of the prompt
            self.recompute_tokens += (ck - rem) + self.q_prompt[rid]
            self.lane_req[w, lane] = -1
            self.lane_rem[w, lane] = 0
            self.active_lanes[w] -= 1
            self.pending_steps[w] -= rem
            # the checkpoint holds state after (q_max_new - ck) tokens, so
            # ck remain; re-admission's prefill token is the first of them
            self._resume_rem[rid] = ck
            self.q_status[rid] = _QUEUED
            self._fo_route(rid, resurrect=True)
        q = self.queues[w]
        while q:
            rid = q.popleft()
            self.queue_len[w] -= 1
            self.pending_prefill[w] -= self.q_prompt[rid]
            self.pending_steps[w] -= self._rem_total(rid)
            self._fo_route(rid, resurrect=False)

    def _fo_route(self, rid: int, *, resurrect: bool) -> None:
        """Failover routing: same score shape as submit(), but never shed
        by admission control — the request was already accepted once."""
        warm = self.alive & (self.warm_rem <= 0.0) & ~self.dead
        room = self.queue_len < self.max_queue_arr
        open_ = warm & ~self.drained & ~self.retiring & room
        if not open_.any():
            open_ = warm & ~self.retiring & room
        if not open_.any():
            self._strand_retry.append((rid, resurrect))
            return
        idx = np.flatnonzero(open_)
        pred = (self._est_wait(idx) + self.q_prompt[rid]
                * self.slowdown[idx] / self.prefill_rate_arr[idx])
        rank = (self._ranks()[idx] if self.thermal_routing
                else np.zeros(len(idx), np.int64))
        best = int(idx[np.lexsort((idx, self.queue_len[idx], pred, rank))[0]])
        self.q_worker[rid] = best
        self.queues[best].append(rid)
        self.queue_len[best] += 1
        self.pending_prefill[best] += self.q_prompt[rid]
        self.pending_steps[best] += self._rem_total(rid)
        if resurrect:
            self.resurrections += 1
            self.events.append((self.sim_t, "resurrect", int(rid)))

    # --- shared: training-plane mirror (serve-while-train charging) ---
    def _fed_resolved(self, w: int) -> bool:
        return w in self._fed_done or w in self._fed_failed

    def _phase_fed(self) -> None:
        """Mirror of :class:`~repro_torch.serving.train_plane.FedRoundCoordinator`
        at capacity level: one active round at a time, each participant
        paying cold training seconds out of the row's leftover per-tick
        credit (after decode), then one update frame over its link.  Runs
        as SHARED code after both decode phases, so loop and vector stay
        bit-identical with the training plane on."""
        fed = self.fed
        if not self._fed_members and self.fed_rounds < fed.rounds:
            ranks = self._ranks()
            elig = (self._serving_mask() & self._earning
                    & (ranks <= fed.max_rank) & (self.queue_len == 0)
                    & (self.active_lanes == 0))
            idx = np.flatnonzero(elig)
            if len(idx):
                # coolest-emptiest-fastest-first, same score shape as the
                # real coordinator's participant selection
                backlog = self.active_lanes[idx] + self.queue_len[idx]
                order = np.lexsort((idx, -self.prefill_rate_arr[idx],
                                    backlog, ranks[idx]))
                picked = idx[order[:fed.participants]]
                self._fed_members = sorted(int(w) for w in picked)
                cold = (fed.local_steps * fed.flops_mult * fed.step_tokens)
                for w in self._fed_members:
                    self._fed_comp[w] = cold / self.prefill_rate_arr[w]
                    self._fed_link[w] = 0.0
                self._fed_done = set()
                self._fed_failed = set()
                self._fed_deadline = self.sim_t + fed.round_timeout_s
        if not self._fed_members:
            return
        for w in self._fed_members:
            if self._fed_resolved(w):
                continue
            # a down row makes no progress; detection (_strand_row) fails
            # it, a blip that heals before detection resumes transparently
            if self.dead[w] or not self._earning[w]:
                continue
            if (self.queue_len[w] > 0 or self.active_lanes[w] > 0
                    or self._ranks()[w] > fed.max_rank):
                self.fed_preempt_ticks += 1
                continue
            if self._fed_comp[w] > 0.0:
                cost_now = self._fed_comp[w] * self.slowdown[w]
                pay = min(cost_now, max(float(self.credit[w]), 0.0))
                if pay > 0.0:
                    self.credit[w] -= pay
                    self._fed_comp[w] -= pay / self.slowdown[w]
                    self.fed_train_s += pay
                    du = pay / self.tick_s
                    self.util[w] = min(self.util[w] + du, 1.0)
                    if self._earning[w] and np.isfinite(self.t_tau[w]):
                        # first-order heat delta of the reservoir update
                        # for the extra util the training spend added
                        dh = self.tick_s * du * (
                            1.0 / self.t_tau[w]
                            + self.heat[w] / (self.t_tau[w] * self.cool_frac))
                        self.heat[w] = min(max(self.heat[w] + dh, 0.0), 1.0)
                if self._fed_comp[w] <= 1e-12:
                    self._fed_comp[w] = 0.0
                    self.fed_wire_bytes += fed.frame_bytes
                    self._fed_link[w] = fed.frame_bytes / self.link_bw_arr[w]
            if self._fed_comp[w] == 0.0 and w not in self._fed_done:
                self._fed_link[w] -= min(self._fed_link[w], self.tick_s)
                if self._fed_link[w] <= 1e-12:
                    self._fed_done.add(w)
        if self.sim_t >= self._fed_deadline:
            for w in self._fed_members:
                if not self._fed_resolved(w):
                    self._fed_failed.add(w)
        if all(self._fed_resolved(w) for w in self._fed_members):
            self.fed_rounds += 1
            self.fed_deliveries += len(self._fed_done)
            self.fed_excluded += len(self._fed_failed)
            self.fed_samples += (len(self._fed_done)
                                 * fed.local_steps * fed.step_tokens)
            self._fed_members = []
            self._fed_comp.clear()
            self._fed_link.clear()
            self._fed_done = set()
            self._fed_failed = set()
            self._fed_deadline = math.inf

    def _checkpoint_lanes(self) -> None:
        """Refresh per-lane checkpoints on live rows (a dead row's state
        is unreachable — its last pre-kill checkpoint stands)."""
        if self.sim_t < self._next_ckpt:
            return
        self._next_ckpt = self.sim_t + self.ckpt_every_s
        live = ~self.dead
        self.lane_ckpt[live] = self.lane_rem[live]

    # ------------------------------------------------------------------
    def snapshot(self) -> ScaleSnapshot:
        n = len(self.q_status)
        terminal = [rid for rid in range(n) if self.q_status[rid] >= 0]
        ttft = [self.q_first[rid] - self.q_submit[rid] for rid in terminal]
        tpot = []
        tokens = []
        for rid in terminal:
            m = self.q_max_new[rid]
            if (self.q_status[rid] == OUTCOME_DONE and m > 1):
                tpot.append((self.q_done[rid] - self.q_first[rid]) / (m - 1))
            else:
                tpot.append(float("nan"))
            tokens.append(m if self.q_status[rid] == OUTCOME_DONE else 0)
        report = slo_report(
            self.slo, [self.q_class[rid] for rid in terminal], ttft, tpot,
            tokens, [self.q_status[rid] for rid in terminal],
            span_s=self.sim_t)
        return ScaleSnapshot(
            sim_t=self.sim_t, ticks=self.ticks, offered=self.offered,
            completed=self.n_done, completed_tokens=self.completed_tokens,
            goodput_tokens_per_s=(self.completed_tokens / self.sim_t
                                  if self.sim_t > 0 else 0.0),
            shed=self.shed, rejected=self.rejected, expired=self.expired,
            queued_now=int(self.queue_len.sum()),
            active_now=int(self.active_lanes.sum()),
            serving_now=int(self._serving_mask().sum()),
            peak_serving=self.peak_serving,
            scale_ups=self.scale_ups, scale_downs=self.scale_downs,
            retired=self.retired,
            warm_bytes_total=self.warm_bytes_total,
            warm_link_s_total=self.warm_link_s_total,
            probes=int(self.probes_arr.sum()),
            drains=self.drains, undrains=self.undrains,
            heat_max=float(self.heat.max()),
            slo=report,
            events=tuple(self.events),
            serving_series=tuple(self.serving_series),
            deaths=self.deaths, resurrections=self.resurrections,
            recompute_tokens=self.recompute_tokens,
            orphaned=len(self._strand_retry),
            fed_rounds=self.fed_rounds,
            fed_deliveries=self.fed_deliveries,
            fed_excluded=self.fed_excluded,
            fed_samples=self.fed_samples,
            fed_train_s=round(self.fed_train_s, 9),
            fed_wire_bytes=self.fed_wire_bytes,
            fed_preempt_ticks=self.fed_preempt_ticks)


def play(fleet: SimFleet, trace, *, max_ticks: int = 10_000_000) -> float:
    """Drive a :class:`~repro_torch.serving.traffic.TrafficTrace` through a
    SimFleet open-loop in simulated time (the model-free analogue of
    the fleet's ``drive_sim``): submit each arrival when its
    sim time comes due, tick until drained, return simulated seconds."""
    t0 = fleet.sim_t
    arrivals = trace.arrivals
    n, i = len(trace), 0
    for _ in range(max_ticks):
        while i < n and arrivals[i] <= fleet.sim_t - t0:
            fleet.submit(int(trace.prompt_lens[i]),
                         int(trace.max_news[i]),
                         class_id=int(trace.classes[i]))
            i += 1
        if i >= n and fleet.idle():
            break
        fleet.tick()
    else:
        warnings.warn(
            f"play exhausted max_ticks={max_ticks} with work outstanding "
            f"({fleet.n_done} finished)", RuntimeWarning, stacklevel=2)
    return fleet.sim_t - t0
