"""Pipeline-split decode: one model's layers spanning several stages
(port of ``repro/serving/pipeline_decode.py``).

The paper's actual topology (§4.1) is a single model cut across host +
phone; a replica set caps the servable model at one worker's
``mem_bytes``.  This module is the stage-execution subsystem that removes
that cap:

* a :class:`PipelineEngine` owns ``max_batch`` decode lanes whose layers
  span N **stages** -- stage 0 runs the below-the-cut layers and owns the
  low-layer KV (its own dense
  :class:`~repro_torch.serving.backends.CacheBackend` over the layer slice,
  via :func:`repro_torch.models.api.stage_model`), stage 1 owns the rest;
* every boundary crossing -- the full-prompt hidden states at prefill, the
  (B, 1, D) residual at each decode step -- is a real **wire frame**:
  encoded and decoded through :mod:`repro_torch.wire.codec`, so the byte
  counts charged against ``DeviceProfile.link_bw`` are the actual framed
  payloads (header + CRC included), and the token-identity claim covers the
  codec round trip.  Decoding gives a host tensor, which is copied to the
  next stage's device: every boundary is a real host round trip;
* the cut comes from :func:`repro_torch.core.partition.split_decode` --
  serving rates + per-token boundary bytes + per-stage memory, searched
  over :class:`~repro_torch.hw.specs.DeviceProfile`\\ s (see
  :func:`plan_decode_split`);
* :meth:`PipelineEngine.recut` re-cuts the split **token-identically**
  (the engine's preempt/resume contract: frozen per-lane sampler PRNG +
  generated-token re-prefill) and reports the layer-param bytes that
  crossed the wire.

The engine mirrors :class:`~repro_torch.serving.engine.ServeEngine`'s fleet
surface (``submit / inject / pull_queued / feasible / preempt / step /
run_until_drained``).  Differences, as in the reference: lanes are dense
per stage (no paged pool across a cut), prefill is per-request
exact-length (no bucketed batching), and requests carrying ``extra`` model
inputs are not admitted (the stage protocol carries tokens and boundary
hidden states only).  Every stage runs on the model's one device.

For external pacing, :meth:`PipelineEngine.step_paced` runs one engine
step eagerly and returns a :class:`StepReport` of everything the step
consumed (per-stage prefill tokens, every boundary frame's bytes, each
stage's decode wall time).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import DecodeSplitPlan, split_decode
from repro_torch.hw.specs import DeviceProfile
from repro_torch.models.api import Model, param_bytes, split_stage_params, stage_model
from repro_torch.models.attention import cache_span
from repro_torch.models.lm import dtype_of
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, Request
from repro_torch.serving.metrics import EngineSnapshot, MetricsCollector
from repro_torch.serving.sampling import GREEDY, Sampler, SamplingParams
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerConfig
from repro_torch.wire import codec


# ---------------------------------------------------------------------------
# cut planning
# ---------------------------------------------------------------------------
def boundary_frame_bytes(model: Model, max_batch: int) -> int:
    """Wire bytes of one decode-step boundary frame -- the (B, 1, D)
    residual as the codec actually frames it (headers + CRC included)."""
    dt = dtype_of(model.rcfg.compute_dtype)
    return len(codec.dumps(torch.zeros((max_batch, 1, model.cfg.d_model), dtype=dt)))


def decode_block_costs(model: Model, params, max_batch: int, max_len: int
                       ) -> List[Tuple[float, float, float]]:
    """Per-layer ``(share, boundary_bytes, mem_bytes)`` for
    :func:`repro_torch.core.partition.split_decode`.

    ``share`` is uniform (a uniform transformer's layers cost the same),
    ``boundary_bytes`` is the real framed decode-step payload, and
    ``mem_bytes`` is the layer's params plus its KV share at ``max_len``
    for ``max_batch`` dense lanes -- what the layer pins on whichever stage
    it lands on."""
    cfg = model.cfg
    n = cfg.n_layers
    frame = boundary_frame_bytes(model, max_batch)
    layer_params = param_bytes(params["blocks"]) / n
    itemsize = dtype_of(model.rcfg.compute_dtype).itemsize
    kv_layer = (max_batch * cache_span(cfg, max_len) * cfg.n_kv_heads
                * cfg.head_dim * 2 * itemsize)
    return [(1.0 / n, float(frame), layer_params + kv_layer)] * n


def stage_fixed_mem(model: Model, params, n_stages: int) -> Tuple[float, ...]:
    """Per-stage constant bytes: the embedding table on stage 0, the final
    norm + head on the last (tied embeddings ship the table to both ends,
    and are charged on both)."""
    embed_b = param_bytes(params["embed"])
    tail = param_bytes(params["final_ln"])
    tail += param_bytes(params["head"]) if "head" in params else embed_b
    fixed = [0.0] * n_stages
    fixed[0] += embed_b
    fixed[-1] += tail
    return tuple(fixed)


def plan_decode_split(model: Model, params,
                      devices: Sequence[DeviceProfile], *,
                      max_batch: int, max_len: int) -> DecodeSplitPlan:
    """Pick the serving cut for ``devices`` from the model's real byte and
    rate numbers (the §4.1 hand-tuned split as a cost search)."""
    costs = decode_block_costs(model, params, max_batch, max_len)
    return split_decode(costs, devices,
                        stage_fixed_mem=stage_fixed_mem(model, params, len(devices)))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepReport:
    """What one (eagerly executed) engine step consumed -- a sim layer's
    charge sheet.  ``prefill_frame_bytes[i]`` / ``decode_frame_bytes[i]``
    are the wire bytes that crossed boundary i (between stages i and
    i+1); ``decode_stage_wall_s[i]`` is the MEASURED wall time of stage
    i's decode dispatch, the device synchronised at its end."""
    admissions: int = 0
    prefill_tokens: int = 0
    prefill_frame_bytes: List[int] = dataclasses.field(default_factory=list)
    decode_frame_bytes: List[int] = dataclasses.field(default_factory=list)
    decode_stage_wall_s: List[float] = dataclasses.field(default_factory=list)
    decode_step: bool = False
    active: int = 0


class _Stage:
    """One layer slice: its model view, params, cache backend, prefill
    (the stage model's exact-length prefill of one request)."""

    def __init__(self, full_model: Model, params, lo: int, hi: int,
                 max_batch: int, max_len: int, config: EngineConfig):
        self.lo, self.hi = lo, hi
        self.model = stage_model(full_model, lo, hi)
        self.params = params
        self.backend = make_backend(self.model, max_batch, max_len, config)
        self.prefill = lambda p, b: self.model.prefill(p, b, max_len)

    @property
    def n_layers(self) -> int:
        return self.hi - self.lo


class PipelineEngine:
    """Continuous-batching decode over lanes whose layers span stages.

    ``cuts`` are block indices where each next stage starts (as in
    :class:`~repro_torch.core.partition.DecodeSplitPlan`); ``()`` is one
    stage holding every layer.  ``params`` may be the full tree (it is
    sliced per stage and not retained) or a pre-split list from
    :func:`repro_torch.models.api.split_stage_params`.
    """

    def __init__(self, model: Model, params, max_batch: int, max_len: int,
                 cuts: Sequence[int], eos_id: Optional[int] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 config: Optional[EngineConfig] = None,
                 clock=None):
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.config = config or EngineConfig()
        self._now = clock or time.perf_counter
        self.vocab = int(model.cfg.vocab_size)
        self.scheduler = AdmissionScheduler(scheduler)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.sampler = Sampler(max_batch)
        # fleet/preempt code reads lane arrays through here
        self.lane_sampling = self.sampler.lanes
        self._rid = 0
        self.steps = 0
        self.recuts = 0
        self.finished: List[Request] = []
        self.metrics = MetricsCollector(n_slots=max_batch)
        # wire-plane counters
        self.frames_sent = 0
        self.frame_bytes_total = 0
        self.prefill_frame_bytes_total = 0
        self.decode_frame_bytes_total = 0
        if isinstance(params, dict):
            params = split_stage_params(model, params, cuts)
        self._build_stages(tuple(int(c) for c in cuts), params)

    def _build_stages(self, cuts: Tuple[int, ...], stage_params: List[dict]) -> None:
        n = self.model.cfg.n_layers
        bounds = (0,) + cuts + (n,)
        if len(stage_params) != len(bounds) - 1:
            raise ValueError(f"{len(stage_params)} param slices for "
                             f"{len(bounds) - 1} stages")
        self.cuts = cuts
        self.stages = [
            _Stage(self.model, stage_params[i], bounds[i], bounds[i + 1],
                   self.max_batch, self.max_len, self.config)
            for i in range(len(bounds) - 1)
        ]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def stage_param_bytes(self) -> Tuple[int, ...]:
        return tuple(param_bytes(st.params) for st in self.stages)

    # ------------------------------------------------------------------
    # submission / admission (ServeEngine fleet surface)
    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               sampling: Optional[SamplingParams] = None, priority: int = 0,
               deadline_s: Optional[float] = None, **extra) -> Optional[int]:
        if extra:
            raise ValueError(
                "pipeline-split lanes carry tokens and boundary hidden "
                "states only; extra model inputs are not supported")
        rid = self._rid
        self._rid += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      submitted_t=self._now(), sampling=sampling or GREEDY,
                      priority=priority, deadline_s=deadline_s)
        if not self.scheduler.push(req, req.submitted_t):
            return None
        return rid

    def inject(self, req: Request, *, force: bool = False) -> bool:
        req.fp_memo = None
        self._rid = max(self._rid, req.rid + 1)
        if force:
            self.scheduler.requeue(req)
            return True
        return self.scheduler.push(req, self._now())

    def pull_queued(self) -> List[Request]:
        return self.scheduler.take_all()

    def feasible(self, req: Request) -> bool:
        # dense stage lanes admit any token-only request (writes past
        # max_len clamp, as dense lanes always did); requests with extra
        # model inputs can't cross a cut
        return not req.extra

    def lane_cost(self, slot: int) -> Tuple[int, int]:
        """(recompute_tokens, footprint) of an active lane -- the fleet's
        cost-aware migration victim ordering.  Stage lanes are dense and
        recompute on resume, so recompute = the full context re-prefill."""
        req = self.slots[slot]
        return self._ctx_len(req), self.max_len

    def _prefill_tokens(self, req: Request) -> np.ndarray:
        if not req.out_tokens:
            return req.prompt
        return np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])

    def _ctx_len(self, req: Request) -> int:
        return len(req.prompt) + len(req.out_tokens)

    def _final_len(self, req: Request) -> int:
        return self._ctx_len(req) - len(req.out_tokens) + req.max_new - 1

    # ------------------------------------------------------------------
    # wire plane
    # ------------------------------------------------------------------
    def _ship(self, x: torch.Tensor, to: int, *, prefill: bool) -> Tuple[torch.Tensor, int]:
        """Push boundary activations through the real wire codec: stage
        ``to`` decodes the framed bytes (a host tensor, copied to its
        device), and the byte count is what a simulation charges against
        the link."""
        payload = codec.dumps(x)
        n = len(payload)
        self.frames_sent += 1
        self.frame_bytes_total += n
        if prefill:
            self.prefill_frame_bytes_total += n
        else:
            self.decode_frame_bytes_total += n
        return codec.loads(payload).to(self.stages[to].model.device), n

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admit(self, rep: StepReport) -> None:
        while self._admit_once(rep):
            pass

    def _admit_once(self, rep: StepReport) -> bool:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        now = self._now()
        batch = self.scheduler.pop(len(free), now)
        if not batch:
            return False
        n_done_before = len(self.finished)
        for req in batch:
            self._admit_one(req, free.pop(0), now, rep)
        return (len(self.finished) > n_done_before
                and self.scheduler.depth > 0)

    def _admit_one(self, req: Request, slot: int, now: float, rep: StepReport) -> None:
        seq = self._prefill_tokens(req)
        n_ctx = len(seq)
        out = x = None
        for i, st in enumerate(self.stages):
            b = ({"tokens": torch.as_tensor(seq[None]).to(torch.int64).to(st.model.device)}
                 if i == 0 else {"hidden": x})
            out, cache1 = st.prefill(st.params, b)
            res = st.backend.alloc(n_ctx, self._final_len(req), None)
            st.backend.prefill_paste(slot, cache1, 0, n_ctx, n_ctx, res)
            if i < self.n_stages - 1:
                x, nb = self._ship(out, i + 1, prefill=True)
                rep.prefill_frame_bytes[i] += nb
        rep.admissions += 1
        rep.prefill_tokens += n_ctx
        self.metrics.on_prefill(1, n_ctx)

        ls = self.lane_sampling
        self.sampler.set_lane(slot, req.sampling)
        if req.saved_key is not None:
            ls.key[slot] = req.saved_key
        tok = int(self.sampler.sample(out[:, :self.vocab], lanes=[slot])[0])
        t_first = self._now()
        req.out_tokens.append(tok)
        if req.admitted_t is None:
            req.first_token_t = t_first
            self.metrics.on_admit(req, now)
        else:
            self.metrics.on_resume(req, now)
        req.admitted_t = now
        req.saved_key = None
        if len(req.out_tokens) >= req.max_new or tok == self.eos_id:
            req.done_t = t_first
            ls.clear_lane(slot)
            for st in self.stages:
                st.backend.release(slot)
            self.finished.append(req)
            self.metrics.on_finish(req, t_first)
            return
        self.slots[slot] = req

    # ------------------------------------------------------------------
    # preemption / re-cut
    # ------------------------------------------------------------------
    def preempt(self, slot: int, requeue: bool = True) -> Request:
        """Evict the lane token-identically (frozen sampler PRNG +
        generated-token re-prefill).  ``requeue=False`` is the fleet's
        migration hook, exactly as on :class:`ServeEngine`."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"lane {slot} is idle: nothing to preempt")
        req.preemptions += 1
        req.saved_key = self.lane_sampling.key[slot].copy()
        req.saved_state = None          # dense stage lanes recompute
        for st in self.stages:
            st.backend.release(slot)
        self.slots[slot] = None
        self.lane_sampling.clear_lane(slot)
        if requeue:
            self.scheduler.requeue(req)
        self.metrics.on_preempt(req)
        return req

    def forget_lane(self, slot: int) -> Request:
        """Release a lane whose device state is gone (worker death):
        :meth:`ServeEngine.forget_lane` semantics for a split engine --
        no snapshot (the stages' devices are unreachable), every stage's
        lane freed, nothing registered in any cache."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"lane {slot} is idle: nothing to forget")
        req.preemptions += 1
        for st in self.stages:
            st.backend.release(slot)
        self.slots[slot] = None
        self.lane_sampling.clear_lane(slot)
        self.metrics.on_preempt(req)
        return req

    def recut(self, cuts: Sequence[int]) -> int:
        """Re-cut the split (elastic rebalance): preempt every lane into
        the local queue (they re-admit token-identically through the new
        stages), reassemble the layer slices to the new bounds, and
        return the bytes of layer params that changed stage -- the weight
        traffic a real re-cut pays over the link before decode resumes."""
        cuts = tuple(int(c) for c in cuts)
        if cuts == self.cuts:
            return 0
        for slot, req in enumerate(self.slots):
            if req is not None:
                self.preempt(slot)
        n = self.model.cfg.n_layers
        blocks = [bp for st in self.stages for bp in st.params["blocks"]]
        full = {"blocks": blocks,
                "embed": self.stages[0].params["embed"],
                "final_ln": self.stages[-1].params["final_ln"]}
        if "head" in self.stages[-1].params:
            full["head"] = self.stages[-1].params["head"]

        def stage_of(bounds: Tuple[int, ...], layer: int) -> int:
            return sum(1 for c in bounds if c <= layer)

        layer_bytes = param_bytes(blocks) / n
        moved = sum(layer_bytes for layer in range(n)
                    if stage_of(self.cuts, layer) != stage_of(cuts, layer))
        stage_params = split_stage_params(self.model, full, cuts)
        self.stages = []        # the old stages' caches go before the new ones are made
        self._build_stages(cuts, stage_params)
        self.recuts += 1
        return int(moved)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @torch.no_grad()
    def step_paced(self) -> Optional[StepReport]:
        """One engine step, executed eagerly, returning its charge sheet
        for a sim layer (``None`` = nothing to do).  ``step()`` is the
        unpaced convenience wrapper."""
        rep = StepReport(prefill_frame_bytes=[0] * (self.n_stages - 1))
        self._admit(rep)
        if self.active() == 0:
            return rep if rep.admissions else None
        toks = np.zeros((self.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            toks[i, 0] = req.out_tokens[-1] if req.out_tokens else req.prompt[-1]
        active = np.asarray([s is not None for s in self.slots])
        x = toks
        out = None
        for i, st in enumerate(self.stages):
            t0 = time.perf_counter()
            out = st.backend.step(st.params, x, active)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            rep.decode_stage_wall_s.append(time.perf_counter() - t0)
            if i < self.n_stages - 1:
                x, nb = self._ship(out, i + 1, prefill=False)
                rep.decode_frame_bytes.append(nb)
        ls = self.lane_sampling
        # the step's one device->host transfer: the last stage's logits feed
        # the host-side sampler in a single batched copy
        nxt = self.sampler.sample(out[:, :self.vocab]).tolist()
        now = self._now()
        busy = self.active()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = nxt[i]
            req.out_tokens.append(tok)
            if req.first_token_t is None:
                req.first_token_t = now
            if len(req.out_tokens) >= req.max_new or tok == self.eos_id:
                req.done_t = now
                self.slots[i] = None
                ls.clear_lane(i)
                for st in self.stages:
                    st.backend.release(i)
                self.finished.append(req)
                self.metrics.on_finish(req, now)
        self.steps += 1
        self.metrics.on_step(self.scheduler.depth, busy, now)
        rep.decode_step = True
        rep.active = busy
        return rep

    def step(self) -> int:
        self.step_paced()
        return self.active()

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.scheduler.depth:
                break
        else:
            if self.active() or self.scheduler.depth:
                warnings.warn(
                    f"run_until_drained exhausted max_steps={max_steps} "
                    f"with {self.active()} active lanes and "
                    f"{self.scheduler.depth} queued requests -- returning "
                    f"PARTIAL results ({len(self.finished)} finished)",
                    RuntimeWarning, stacklevel=2)
        return self.finished

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.scheduler.peek_order()

    def reset_stats(self) -> None:
        self.finished.clear()
        self.scheduler.rejected.clear()
        self.scheduler.expired.clear()
        self.scheduler.rejected_total = 0
        self.scheduler.expired_total = 0
        self.steps = 0
        self.metrics = MetricsCollector(n_slots=self.max_batch)
        self.frames_sent = 0
        self.frame_bytes_total = 0
        self.prefill_frame_bytes_total = 0
        self.decode_frame_bytes_total = 0

    def metrics_snapshot(self) -> EngineSnapshot:
        return self.metrics.snapshot(
            queue_depth_now=self.scheduler.depth,
            rejected=self.scheduler.rejected_total,
            expired=self.scheduler.expired_total)
