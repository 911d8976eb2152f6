"""Speculative decoding: draft k tokens cheap, verify them in one window
(port of ``repro/serving/speculative.py``).

The paper's fleet pairs a fast-but-throttling phone with a slow-but-steady
host: the rate asymmetry speculative decoding turns into wall-clock speed.
A small DRAFT model proposes ``k`` tokens a round, the TARGET model
verifies the whole proposal in one window
(:meth:`~repro_torch.serving.backends.DenseBackend.verify_step`), and the
accepted tokens commit together.  :class:`SpecEngine` subclasses the plain
:class:`~repro_torch.serving.engine.ServeEngine`, so admission, scheduling,
preemption, prefix caching and metrics are shared; only the decode round
differs.

**Coupled acceptance = the plain engine's stream.**  At window position j
the target's logits are exactly the logits the plain engine computes for
that decode step (the window is a loop of the single-step call, bitwise
equal by construction: :func:`repro_torch.models.lm.lm_decode_window`), and
the emitted token is sampled from them through the lane's own key by the
same :class:`~repro_torch.serving.sampling.Sampler`, on the device the
logits live on.  The drafted token only decides whether the round goes on
past j (iff the target's own sample equals the proposal).  So the emitted
stream is the plain engine's, for greedy and stochastic lanes; the draft
controls only how many tokens a round commits.  A lane takes one draw per
emitted token (masked sampling), so preempt/resume stays token-identical.

**Cache discipline.**  Both sides keep the invariant *cache content =
stream[:-1]* between rounds (stream = prompt + generated; the newest token
is fed, not yet written).  A round:

1. draft catch-up: a width-1 verify window feeds ``stream[-1]`` (writes
   it; its logits propose t1), then ``k`` single draft steps feed t1..tk
   (the last step only writes tk; its logits are discarded unsampled);
2. the drafted row crosses to the target as a real wire-codec frame
   (skipped when colocated);
3. target verify: a width k+1 window over ``[stream[-1], t1..tk]``;
4. coupled acceptance emits ``n`` tokens (1 <= n <= k+1);
5. both sides ``rollback(slot, (k+1) - n)``: dense and paged lanes move
   the write position back, recurrent lanes replay the kept prefix from
   a copy of the pre-round state;
6. the emitted row and the advanced keys cross back as the sync frame.
   The port's keys are ``(seed, counter)`` int64 pairs, where the
   reference ships threefry uint32 key data: the frame is wider by the
   key field's width.

The draft :class:`Sampler` copies the target's full lane state at every
round start, so a perfectly aligned draft proposes exactly what the target
will sample (acceptance 1.0), stochastic lanes included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serving.backends import Reservation, make_backend
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.sampling import Sampler, SamplingParams
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.wire import codec


@dataclasses.dataclass
class SpecReport:
    """What one :meth:`SpecEngine.step_paced` round did: the fleet's
    charging input (compute per side, frame bytes per direction)."""
    n_active: int = 0              # lanes that ran the round
    spec_k: int = 0
    emitted_tokens: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    d2t_frame_bytes: int = 0       # drafted tokens, draft -> target
    t2d_frame_bytes: int = 0       # emitted row + key sync, target -> draft
    draft_prefill_tokens: int = 0  # draft-side catch-up prefills this round
    target_prefill_tokens: int = 0  # target-side admission prefills this round


class SpecEngine(ServeEngine):
    """A ServeEngine whose decode step is a draft -> verify round.

    ``colocated=True`` models the degraded-fleet fallback: draft and target
    share one worker, so the token exchange never touches the link (frame
    bytes report 0).  The decode mechanics are identical either way.
    """

    def __init__(self, model: Model, params, draft_model: Model, draft_params,
                 max_batch: int, max_len: int, *, spec_k: int = 3,
                 colocated: bool = False, eos_id: Optional[int] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 prefill_buckets=None, max_prefill_batch: int = 8,
                 config: Optional[EngineConfig] = None, clock=None):
        super().__init__(model, params, max_batch, max_len, eos_id=eos_id,
                         scheduler=scheduler, prefill_buckets=prefill_buckets,
                         max_prefill_batch=max_prefill_batch, config=config, clock=clock)
        if int(draft_model.cfg.vocab_size) != self.vocab:
            raise ValueError(f"draft vocab {draft_model.cfg.vocab_size} != target vocab "
                             f"{self.vocab}: acceptance compares token ids")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_k = spec_k
        self.colocated = colocated
        self.draft_model = draft_model
        self.draft_params = draft_params
        # the draft side never pages (its lanes mirror the target's
        # admission): dense lanes, or recurrent lanes for a recurrent draft
        dkind = draft_model.decode_state.kind
        self.draft_backend = make_backend(
            draft_model, max_batch, max_len,
            EngineConfig(backend="recurrent" if dkind == "recurrent" else "dense"))
        self.draft_sampler = Sampler(max_batch)
        self._draft_ready = [False] * max_batch

    # ------------------------------------------------------------------
    # surface overrides
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, sampling: Optional[SamplingParams] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               **extra) -> Optional[int]:
        if extra:
            raise TypeError(f"SpecEngine takes no extra model inputs (the draft side "
                            f"prefills pure token streams); got {sorted(extra)}")
        return super().submit(prompt, max_new, sampling=sampling, priority=priority,
                              deadline_s=deadline_s)

    def feasible(self, req: Request) -> bool:
        return not req.extra and super().feasible(req)

    def preempt(self, slot: int, requeue: bool = True) -> Request:
        req = super().preempt(slot, requeue=requeue)
        self._release_draft(slot)
        return req

    def forget_lane(self, slot: int) -> Request:
        req = super().forget_lane(slot)
        self._release_draft(slot)
        return req

    # ------------------------------------------------------------------
    # draft-lane upkeep
    # ------------------------------------------------------------------
    def _release_draft(self, slot: int) -> None:
        self._draft_ready[slot] = False
        self.draft_backend.release(slot)

    def _sync_draft_lanes(self) -> int:
        """Bring the draft cache of every newly (re)admitted lane to the
        invariant (content = stream[:-1]) by an exact-length prefill of the
        draft model; returns the prefilled token count."""
        n_tokens = 0
        for slot, req in enumerate(self.slots):
            if req is None or self._draft_ready[slot]:
                continue
            pre = self._prefill_tokens(req)[:-1]
            if len(pre) == 0:
                self.draft_backend.reset_lane(slot)
            else:
                _, cache = self.draft_model.prefill(
                    self.draft_params, {"tokens": self._to_device(pre[None])}, self.max_len)
                self.draft_backend.prefill_paste(slot, cache, 0, len(pre), len(pre),
                                                 Reservation())
                n_tokens += len(pre)
            self._draft_ready[slot] = True
        return n_tokens

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def step(self) -> int:
        self.step_paced()
        return self.active()

    @torch.no_grad()
    def step_paced(self) -> SpecReport:
        """Admit, then run one draft -> verify round.  Returns the charging
        report (``n_active == 0``: nothing ran, an idle tick)."""
        rep = SpecReport(spec_k=self.spec_k)
        pf0 = self.metrics.prefill_tokens
        self._prepare_lanes()
        self._admit()
        self._prepare_lanes()
        rep.target_prefill_tokens = self.metrics.prefill_tokens - pf0
        rep.draft_prefill_tokens = self._sync_draft_lanes()
        if self.active() == 0:
            return rep
        k = self.spec_k
        w = k + 1
        b = self.max_batch

        # ---- draft phase: catch-up window + k single steps ------------
        self.draft_sampler.copy_state_from(self.sampler)
        active = np.asarray([s is not None for s in self.slots])
        last = np.zeros((b, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                last[i, 0] = self._prefill_tokens(req)[-1]
        # a width-1 verify window, not a bare step: a recurrent draft
        # stashes its pre-round state here, which rollback replays
        d_logits = self.draft_backend.verify_step(self.draft_params, last, active)
        drafted = np.zeros((b, k), np.int32)
        drafted[:, 0] = self.draft_sampler.sample(d_logits[:, 0, :self.vocab], mask=active)
        for j in range(1, k + 1):
            # step j writes t_j; its logits propose t_{j+1}.  The last step
            # only writes (the draft must hold t_k in case the whole
            # proposal is accepted): its logits go unsampled, so no lane
            # takes a draw for a token that does not exist
            step_logits = self.draft_backend.step(self.draft_params, drafted[:, j - 1:j], active)
            if j < k:
                drafted[:, j] = self.draft_sampler.sample(step_logits[:, :self.vocab],
                                                          mask=active)

        # ---- drafted tokens cross the wire (draft -> target) ----------
        if not self.colocated:
            rows = np.flatnonzero(active)
            rids = np.asarray([self.slots[i].rid for i in rows], np.int64)
            buf = codec.dumps({"rids": rids, "toks": drafted[rows]})
            rep.d2t_frame_bytes = len(buf)
            rx = codec.loads(buf)       # an honest round trip: use the decoded data
            drafted[rows] = rx["toks"].numpy()

        # ---- target verify: reserve W writes, then one window ----------
        window = np.zeros((b, w), np.int32)
        window[:, 0] = last[:, 0]
        window[:, 1:] = drafted
        for slot in range(b):
            if self.slots[slot] is None:
                continue
            # the window writes W positions from the lane's current one;
            # reserve them all (paged grows / COW-splits per position)
            while not self.backend.append_tokens(slot, window[slot]):
                victim = self._pick_victim()
                self.preempt(victim)
                if victim == slot:
                    break
        active = np.asarray([s is not None for s in self.slots])
        if not active.any():
            return rep
        w_logits = self.backend.verify_step(self.params, window, active)

        # ---- coupled acceptance, on the logits' device -----------------
        limit = np.asarray([req.max_new - len(req.out_tokens) if req else 1
                            for req in self.slots])
        emitted, n_emitted, n_acc = self.sampler.accept(
            w_logits[:, :, :self.vocab], drafted, active, limit, eos_id=self.eos_id)
        rep.n_active = int(active.sum())
        # only drafts the acceptance loop could reach count toward the
        # rate: proposals past a lane's remaining budget are unverifiable
        rep.drafted_tokens = int(np.minimum(k, limit)[active].sum())
        rep.accepted_tokens = int(n_acc[active].sum())
        rep.emitted_tokens = int(n_emitted[active].sum())
        self.metrics.on_spec_round(rep.drafted_tokens, rep.accepted_tokens)

        # ---- commit + rollback (rollback BEFORE release, so the prefix
        # cache registers exactly the content the lane holds) -----------
        now = self._now()
        busy = int(active.sum())
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            n = int(n_emitted[i])  # repro-lint: allow[R004] n_emitted is host numpy from Sampler.accept; a dtype cast, not a sync
            self.backend.rollback(i, w - n)
            self.draft_backend.rollback(i, w - n)
            req.out_tokens.extend(emitted[i])
            if req.first_token_t is None:
                req.first_token_t = now
            if len(req.out_tokens) >= req.max_new or emitted[i][-1] == self.eos_id:
                req.done_t = now
                self.slots[i] = None
                self.lane_sampling.clear_lane(i)
                self.backend.release(i, tokens=self._cache_tokens(req))
                self._release_draft(i)
                self.finished.append(req)
                self.metrics.on_finish(req, now)

        # ---- emitted row + key sync back (target -> draft) -------------
        if not self.colocated:
            rows = np.flatnonzero(active)
            em = np.full((len(rows), w), -1, np.int32)
            for r, i in enumerate(rows):
                em[r, :len(emitted[i])] = emitted[i]
            buf = codec.dumps({"emitted": em, "n_emitted": n_emitted[rows],
                               "keys": self.sampler.lanes.key[rows]})
            rep.t2d_frame_bytes = len(buf)
            codec.loads(buf)
        self.steps += 1
        self.metrics.on_step(self.scheduler.depth, busy, now,
                             blocks_in_use=self.backend.blocks_in_use)
        return rep
