"""Serving engine: continuous-batching decode over a CacheBackend
(port of ``repro/serving/engine.py``).

Slots: a fixed ``max_batch`` of cache lanes; queued requests are admitted
into free lanes by a pluggable :mod:`scheduler` policy, decode advances
every active lane one token per step, and finished lanes free at once
(continuous batching).  Decode state lives behind one
:class:`~repro_torch.serving.backends.CacheBackend`; the port has the dense
layout (one ``max_len``-wide lane per slot).

Prefill is **bucketed and batched**: prompts are right-padded to a small set
of length buckets and several admissions share one batched-prefill call
(exact for full-causal-attention configs, see
:func:`repro_torch.models.lm.lm_prefill_padded`), whose per-lane caches are
then pasted into their decode lanes.  Requests carrying extra model inputs
take the exact-length per-request prefill.

Sampling is per request (:class:`~repro_torch.serving.sampling.SamplingParams`),
and a :class:`~repro_torch.serving.metrics.MetricsCollector` keeps TTFT / TPOT /
throughput / utilisation accounting.  The engine never owns a run loop
beyond :meth:`ServeEngine.run_until_drained`; ``inject``, ``preempt(slot,
requeue=False)``, ``forget_lane`` and ``pull_queued`` are the hooks a fleet
uses.  Tensors go to the model's device (``cuda`` unless built otherwise).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serving.backends import make_backend
from repro_torch.serving.metrics import EngineSnapshot, MetricsCollector
from repro_torch.serving.sampling import GREEDY, Sampler, SamplingParams
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide knobs (model- and policy-independent).

    ``pad_id`` fills the right-pad region of bucketed prefill batches.  The
    padded positions are causally masked out of every real token, so any id
    inside the vocab is correct; it is configurable so that vocabularies
    where 0 is a live token can pick an unambiguous filler.  The paged
    layout's knobs (``kv_blocks``, ``prefix_cache``, ...) arrive with the
    paged backend.
    """
    pad_id: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new: int = 16
    extra: dict = dataclasses.field(default_factory=dict)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_t: float = 0.0
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    sampling: SamplingParams = GREEDY
    priority: int = 0
    deadline_s: Optional[float] = None
    admitted_t: Optional[float] = None
    preemptions: int = 0
    # PRNG counter frozen at preemption so a stochastic request resumes on
    # exactly the sample stream it would have continued on
    saved_key: Optional[np.ndarray] = None


def default_buckets(max_len: int, smallest: int = 16) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to max_len."""
    out, b = [], smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class ServeEngine:
    def __init__(self, model: Model, params, max_batch: int, max_len: int,
                 eos_id: Optional[int] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_prefill_batch: int = 8,
                 config: Optional[EngineConfig] = None,
                 clock=None):
        self.model = model
        self.params = params
        # the engine's notion of "now" for queue waits, deadlines and
        # latency stamps.  Standalone engines run on the wall clock; a
        # simulated fleet passes its SIM clock so Request.deadline_s is
        # evaluated against simulated seconds, not host wall time
        self._now = clock or time.perf_counter
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.config = config or EngineConfig()
        # logit width is pad_vocab(vocab); the pad columns carry real random
        # head weights, so sampling must be restricted to the true vocab
        self.vocab = int(model.cfg.vocab_size)
        self.scheduler = AdmissionScheduler(scheduler)
        self.buckets = tuple(sorted(prefill_buckets)) if prefill_buckets \
            else default_buckets(max_len)
        if self.buckets[-1] > max_len:
            raise ValueError(
                f"prefill bucket {self.buckets[-1]} exceeds max_len "
                f"{max_len}: prefilling past the cache span would drop "
                f"real prompt K/V")
        self.max_prefill_batch = max(1, min(max_prefill_batch, max_batch))
        self.slots: List[Optional[Request]] = [None] * max_batch
        # the Sampler owns the per-lane filter + PRNG state; lane_sampling
        # aliases its SoA arrays (pre-Sampler code paths mutate in place)
        self.sampler = Sampler(max_batch)
        self.lane_sampling = self.sampler.lanes
        self._rid = 0
        self.steps = 0
        self.finished: List[Request] = []

        # ALL decode state lives here
        self.backend = make_backend(model, max_batch, max_len)
        self.metrics = MetricsCollector(n_slots=max_batch)

        self._device = model.device
        batched = model.decode_state.batched_prefill
        self._prefill_n = None if batched is None else (
            lambda p, toks, lens: batched(p, {"tokens": toks}, lens, max_len))

    # ------------------------------------------------------------------
    # clock
    # ------------------------------------------------------------------
    @property
    def clock(self) -> Callable[[], float]:
        """The engine's time source (wall ``time.perf_counter`` by default,
        a sim clock when constructed with ``clock=``).  Drivers pace by this
        so sim-time engines are never slept against wall time."""
        return self._now

    def now(self) -> float:
        """Current time on the engine's clock (seconds)."""
        return self._now()

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               sampling: Optional[SamplingParams] = None, priority: int = 0,
               deadline_s: Optional[float] = None, **extra) -> Optional[int]:
        """Queue a request; returns its rid, or None if admission control
        rejected it (queue at max_queue).

        ``sampling`` (a :class:`SamplingParams`) is the decode policy (the
        reference's deprecated loose ``temperature=``/``seed=`` kwargs are
        not ported); ``extra`` kwargs are model inputs."""
        rid = self._rid
        self._rid += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new, extra,
                      submitted_t=self._now(),
                      sampling=sampling or GREEDY, priority=priority,
                      deadline_s=deadline_s)
        if not self.scheduler.push(req, req.submitted_t):
            return None
        return rid

    def inject(self, req: Request, *, force: bool = False) -> bool:
        """Admit an externally-built Request (fleet routing / migration).

        ``force`` bypasses ``max_queue`` — a migrated request already owes a
        client tokens and must never be dropped at the door."""
        # keep locally-generated rids unique if submit() and inject() mix
        self._rid = max(self._rid, req.rid + 1)
        if force:
            self.scheduler.requeue(req)
            return True
        return self.scheduler.push(req, self._now())

    def pull_queued(self) -> List[Request]:
        """Remove and return every queued request (fleet-level re-routing
        of a drained worker's backlog).  Active lanes are untouched."""
        return self.scheduler.take_all()

    def feasible(self, req: Request) -> bool:
        """True if this engine's backend could EVER admit the request —
        the side-effect-free alloc-INFEASIBLE predicate.  Fleet migration
        checks it before moving a mid-flight request here, because a
        request that has already produced tokens must never be dropped by
        the destination's admission control."""
        return self.backend.fits(self._ctx_len(req), self._final_len(req))

    def lane_cost(self, slot: int) -> Tuple[int, int]:
        """(recompute_tokens, footprint) of an active lane — the fleet's
        cost-aware migration victim ordering.  A dense lane resumes by a
        re-prefill of its full context."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"lane {slot} is idle: no cost to report")
        return self._ctx_len(req), self._footprint(req)

    def _prefill_tokens(self, req: Request) -> np.ndarray:
        """Tokens to prefill: the prompt, plus — after a preemption — every
        token generated so far, so the request resumes where it left off."""
        if not req.out_tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.out_tokens, np.int32)])

    def _ctx_len(self, req: Request) -> int:
        """Cache positions the prefill will occupy (frontend rows included)."""
        n = len(req.prompt) + len(req.out_tokens)
        fe = req.extra.get("frontend")
        if fe is not None:
            n += fe.shape[0]
        return n

    def _final_len(self, req: Request) -> int:
        """Positions held at completion: context + every still-to-come
        token except the last (which is sampled but never written)."""
        return self._ctx_len(req) - len(req.out_tokens) + req.max_new - 1

    def _footprint(self, req: Request) -> int:
        """Admission footprint: the cache positions the backend holds for it."""
        return self.backend.token_footprint(self._ctx_len(req), req.max_new)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(a)
        if t.dtype == torch.int32:
            t = t.to(torch.int64)
        return t.to(self._device)

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        # past the largest bucket: pad to max_len (one more prefill shape,
        # not one per distinct prompt length)
        return self.max_len

    def _admit_group(self, items: List[Request], slots: List[int], logits,
                     group_cache, now: float) -> None:
        """Sample all first tokens in ONE dispatch, then paste each lane."""
        ls = self.lane_sampling
        for req, slot in zip(items, slots):
            ls.set_lane(slot, req.sampling)
            if req.saved_key is not None:     # resume: continue the stream
                ls.key[slot] = req.saved_key
        toks = self.sampler.sample(logits[:, :self.vocab],
                                   lanes=np.asarray(slots))
        t_first = self._now()
        for j, (req, slot) in enumerate(zip(items, slots)):
            tok = int(toks[j])
            req.out_tokens.append(tok)
            if req.admitted_t is None:
                req.first_token_t = t_first
                self.metrics.on_admit(req, now)
            else:
                self.metrics.on_resume(req, now)
            req.admitted_t = now
            req.saved_key = None
            if len(req.out_tokens) >= req.max_new or tok == self.eos_id:
                # finished at admission: never occupies a decode lane
                req.done_t = t_first
                ls.clear_lane(slot)
                self.finished.append(req)
                self.metrics.on_finish(req, t_first)
                continue
            self.backend.prefill_paste(slot, group_cache, j)
            self.slots[slot] = req

    def _admit(self) -> None:
        # loop: requests that finish AT admission (max_new=1 / instant EOS)
        # leave their lane idle — refill it this round, not next step
        while self._admit_once():
            pass

    def _admit_once(self) -> bool:
        """One admission round; True if a lane freed up again (re-admit)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        now = self._now()
        batch = self.scheduler.pop(len(free), now)
        if not batch:
            return False
        n_done_before = len(self.finished)

        # dense lanes hold any request (the lane count bounds admission), so
        # every popped request is prefilled: batched-bucketed where exact,
        # else at its exact length
        batched: List[Request] = []
        fallback: List[Request] = []
        for req in batch:
            ok = (self._prefill_n is not None and not req.extra
                  and self._ctx_len(req) <= self.max_len)
            (batched if ok else fallback).append(req)

        # group eligible requests by padded bucket length, then chunk each
        # group to the prefill batch limit -> one dispatch per chunk
        groups = {}
        for req in batched:
            groups.setdefault(self._bucket_len(self._ctx_len(req)), []).append(req)
        for blen, items in sorted(groups.items()):
            for i in range(0, len(items), self.max_prefill_batch):
                chunk = items[i:i + self.max_prefill_batch]
                toks = np.full((len(chunk), blen), self.config.pad_id,
                               np.int32)
                lens = np.zeros((len(chunk),), np.int32)
                for j, req in enumerate(chunk):
                    seq = self._prefill_tokens(req)
                    toks[j, :len(seq)] = seq
                    lens[j] = len(seq)
                logits, group_cache = self._prefill_n(
                    self.params, self._to_device(toks), self._to_device(lens))
                self.metrics.on_prefill(len(chunk), blen * len(chunk))
                slots = [free.pop(0) for _ in chunk]
                self._admit_group(chunk, slots, logits, group_cache, now)
        for req in fallback:
            seq = self._prefill_tokens(req)
            b = {"tokens": self._to_device(seq[None])}
            for k, v in req.extra.items():
                b[k] = self._to_device(np.asarray(v)[None])
            logits, one_cache = self.model.prefill(self.params, b, self.max_len)
            self.metrics.on_prefill(1, self._ctx_len(req))
            self._admit_group([req], [free.pop(0)], logits, one_cache, now)

        return (len(self.finished) > n_done_before
                and self.scheduler.depth > 0)

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def _pick_victim(self) -> int:
        """LIFO (recompute) policy: preempt the most recently admitted lane
        — it has the least decode work to throw away and re-prefill, and
        old requests can't be starved by a stream of newer ones."""
        cands = [i for i, r in enumerate(self.slots) if r is not None]
        return max(cands,
                   key=lambda i: (self.slots[i].admitted_t,
                                  self.slots[i].rid))

    def preempt(self, slot: int, requeue: bool = True) -> Request:
        """Evict the lane, release its capacity, and requeue the request
        (which resumes token-identically by recompute-prefill).

        ``requeue=False`` returns the request WITHOUT putting it back on
        this engine's queue — the fleet hook for migrating a lane to
        another worker, where ``inject(req, force=True)`` re-admits it
        (the frozen sampler PRNG and generated-token requeue travel with
        the Request, so the resume is token-identical on any engine
        serving the same model/params)."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"lane {slot} is idle: nothing to preempt")
        req.preemptions += 1
        req.saved_key = self.lane_sampling.key[slot].copy()
        self.backend.release(slot)
        self.slots[slot] = None
        self.lane_sampling.clear_lane(slot)
        if requeue:
            self.scheduler.requeue(req)
        self.metrics.on_preempt(req)
        return req

    def forget_lane(self, slot: int) -> Request:
        """Release a lane whose DEVICE is gone (worker death): free the
        host-side bookkeeping without touching device state.  Unlike
        :meth:`preempt` it saves no sampling key (the lane's device is
        unreachable).  Returns the request for the failover plane, which
        restores ``saved_key`` from its last lane checkpoint before
        re-injecting it elsewhere."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"lane {slot} is idle: nothing to forget")
        req.preemptions += 1
        self.slots[slot] = None
        self.lane_sampling.clear_lane(slot)
        self.backend.release(slot)
        self.metrics.on_preempt(req)
        return req

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self) -> int:
        """Admit + one decode step for all active lanes. Returns #active."""
        self._admit()
        if self.active() == 0:
            return 0
        toks = np.zeros((self.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                toks[i, 0] = req.out_tokens[-1]     # the lane's last sampled token
        active = np.asarray([s is not None for s in self.slots])
        logits = self.backend.step(self.params, toks, active)
        ls = self.lane_sampling
        # one host transfer per step: Sampler.sample returns host numpy;
        # tolist() converts the whole batch at once so the per-lane loop
        # below never touches a device tensor element-wise
        nxt = self.sampler.sample(logits[:, :self.vocab]).tolist()
        now = self._now()
        busy = self.active()          # before the finish-scan frees lanes
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = nxt[i]
            req.out_tokens.append(tok)
            if len(req.out_tokens) >= req.max_new or tok == self.eos_id:
                req.done_t = now
                self.slots[i] = None                # lane freed immediately
                ls.clear_lane(i)
                self.backend.release(i)
                self.finished.append(req)
                self.metrics.on_finish(req, now)
        self.steps += 1
        self.metrics.on_step(self.scheduler.depth, busy, now)
        return self.active()

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            # step() admits first, so one call per iteration does both
            if self.step() == 0 and not self.scheduler.depth:
                break
        else:
            if self.active() or self.scheduler.depth:
                warnings.warn(
                    f"run_until_drained exhausted max_steps={max_steps} "
                    f"with {self.active()} active lanes and "
                    f"{self.scheduler.depth} queued requests — returning "
                    f"PARTIAL results ({len(self.finished)} finished)",
                    RuntimeWarning, stacklevel=2)
        return self.finished

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        """Waiting requests in current admission order."""
        return self.scheduler.peek_order()

    def reset_stats(self) -> None:
        """Drop finished/rejected/expired records and metrics counters —
        e.g. after a warm-up pass — without touching lanes or queue."""
        self.finished.clear()
        self.scheduler.rejected.clear()
        self.scheduler.expired.clear()
        self.scheduler.rejected_total = 0
        self.scheduler.expired_total = 0
        self.steps = 0
        self.metrics = MetricsCollector(n_slots=self.max_batch)

    def metrics_snapshot(self) -> EngineSnapshot:
        return self.metrics.snapshot(
            queue_depth_now=self.scheduler.depth,
            rejected=self.scheduler.rejected_total,
            expired=self.scheduler.expired_total)
