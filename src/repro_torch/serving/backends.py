"""Cache backends: the decode-state layouts behind one protocol
(port of ``repro/serving/backends.py``, dense and paged layouts).

The engine holds one :class:`CacheBackend`, picked by :func:`make_backend`,
and speaks only its verbs (``slot`` is a lane index):

* ``token_footprint(n_ctx, max_new, tokens)`` -- admission charge in cache
  positions; prefix-cache aware for the paged layout.
* ``alloc(n_ctx, final_len, tokens)`` -- reserve capacity for one request:
  a :class:`Reservation`, ``None`` when it cannot fit *now* (back to the
  queue), or :data:`INFEASIBLE` when it can never fit (reject up front).
* ``prefill_paste(slot, group_cache, src_lane, n_ctx, width, res)`` --
  scatter one lane of a (possibly right-padded, batched) prefill cache into
  the backend's storage for ``slot``.
* ``activate(slot, res, n_ctx)`` -- install a FULL-HIT reservation without
  a prefill: every needed K/V position is already cached.
* ``prepare_lane(slot)`` -- make the lane's next write position safe before
  a decode step (grow, COW-split, uncache); ``False`` = out of memory, the
  engine preempts a victim and retries.
* ``step(params, tokens, active)`` -- advance every lane one token.
* ``append_tokens(slot, toks)`` / ``verify_step(params, tokens, active)`` /
  ``rollback(slot, n)`` -- speculative verify: reserve write capacity for
  ``len(toks)`` consecutive positions (paged grows / COW-splits per
  position, all or nothing; ``False`` = pool exhausted), advance every lane
  W tokens and return the logits after each (B, W, Vp), then un-write the
  last ``n`` of a lane's positions after partial acceptance (dense and
  paged move the position back; recurrent state is not
  position-addressed, so the backend replays the kept prefix from a copy
  of the pre-window state).
* ``reset_lane(slot)`` -- return a lane to the empty-stream state (the
  draft side of a speculative pair admits 1-token prompts with nothing to
  prefill).
* ``snapshot(slot)`` / ``restore(slot, snap)`` -- preemption support: a
  layout with a small constant-size state returns a host copy of the lane,
  and a preempted request resumes from it without recompute; ``None`` /
  ``False`` mean the recompute (re-prefill) policy applies.
* ``release(slot, tokens)`` -- free the lane; paged registers the token
  content actually written so future prompts can prefix-match it.

Implementations: :class:`DenseBackend` (one ``max_len``-wide lane per
slot; whisper's lanes also hold the encoder rows' cross K/V), :class:`PagedBackend` (block-pooled KV with refcounted
copy-on-write prefix caching over :class:`BlockManager`) and
:class:`RecurrentBackend` (rwkv and zamba2: constant-footprint state lanes,
admission charged in state units, snapshot/restore preemption).

Where the reference's jitted helpers return updated caches, the backends
here update the cache tensors on the model's device in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.attention import cache_span
from repro_torch.serving.block_manager import BlockManager

# alloc() verdict: the request can NEVER fit (final footprint exceeds the
# pool or the lane span) -- reject up front, don't requeue forever.
INFEASIBLE = object()


@dataclasses.dataclass
class Reservation:
    """Capacity reserved by ``alloc`` for one admission.

    ``blocks`` / ``n_cached`` are paged-layout details (empty elsewhere);
    ``full_hit`` marks a reservation whose every context position short of
    the last is already cached -- the engine skips prefill and calls
    ``activate``.  ``n_lookup`` is the token count of the prefix-cache
    query (0 = no lookup happened) for hit-rate accounting.
    """

    blocks: List[int] = dataclasses.field(default_factory=list)
    n_cached: int = 0
    n_lookup: int = 0
    full_hit: bool = False


def lane_leaves(cache: dict, lane: int) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Lane ``lane`` of every leaf of a lane-layout cache, as views keyed by
    the leaf's path: the layer-stacked leaves and zamba2's slot-stacked
    ``ak``/``av`` hold their lanes on axis 1, ``pos`` on axis 0."""
    out = {("layers", name): t[:, lane] for name, t in cache["layers"].items()}
    out.update({(name,): t[lane] if name == "pos" else t[:, lane]
                for name, t in cache.items() if name != "layers"})
    return out


class CacheBackend:
    """Base class: the attributes fleet code reads off every backend
    (``REQUIRED_ATTRS``), the gauges and the snapshot verbs, at the values
    of a layout without blocks, versioned state or free snapshots."""

    REQUIRED_ATTRS = ("name", "n_blocks", "state_version", "snapshot_free")

    name = "dense"

    def __init__(self, model: Model, n_lanes: int, max_len: int):
        self.model = model
        self.n_lanes = n_lanes
        self.max_len = max_len

    # -- gauges (zeros unless the layout tracks them) -------------------
    n_blocks = 0
    blocks_in_use = 0
    peak_blocks = 0
    shared_blocks_peak = 0
    cow_splits = 0
    cache_evictions = 0
    # bumped whenever capacity/match state changes; footprints computed at
    # one version stay valid while it holds (engine memoizes against it)
    state_version = 0
    # True where snapshot()/restore() resume a preempted lane WITHOUT recompute
    snapshot_free = False

    def snapshot(self, slot: int) -> Optional[Dict[Tuple[str, ...], torch.Tensor]]:
        """A host copy of the lane's state, or None: the recompute policy,
        the resume re-prefills."""
        return None

    def restore(self, slot: int, snap) -> bool:
        """Install ``snap`` into the lane; False (and nothing changed) where
        the layout takes no snapshots."""
        return False

    def fits(self, n_ctx: int, final_len: int) -> bool:
        """Could a request with this FINAL footprint ever be admitted
        here?  The side-effect-free face of ``alloc``'s INFEASIBLE
        verdict -- fleet migration consults it before picking a
        destination, so a mid-flight request is never moved onto a
        worker that must reject it."""
        return True

    def cached_prefix_tokens(self, tokens) -> int:
        """Context positions a re-prefill of ``tokens`` would find already
        cached HERE.  Zero unless the layout runs a prefix cache."""
        return 0

    def forget_cache(self) -> int:
        """Drop reusable cached content (a worker rejoining cold must not
        serve stale registrations as hits).  Returns entries dropped."""
        return 0

    # capacity the admission scheduler may pack against; None = the lane
    # count is the only bound (footprints are not budget-constrained)
    @property
    def budget_tokens(self) -> Optional[int]:
        return None

    @property
    def capacity_tokens(self) -> Optional[int]:
        return None

    def reset_counters(self) -> None:
        pass


class DenseBackend(CacheBackend):
    """One ``max_len``-wide cache lane per slot.  The cache tensors live on
    the model's device and are updated in place."""

    name = "dense"

    def __init__(self, model: Model, n_lanes: int, max_len: int):
        super().__init__(model, n_lanes, max_len)
        # an encoder-decoder's self-attention lanes are max_len wide whatever
        # the config's attention (its cross rows are the encoder's)
        self._span = (cache_span(model.cfg, max_len) if model.decode_state.kind != "encdec"
                      else max_len)
        self.cache = model.init_cache(n_lanes, max_len)

    def token_footprint(self, n_ctx: int, max_new: int,
                        tokens: Optional[Sequence[int]] = None) -> int:
        # a lane is max_len wide no matter how short the request is --
        # that fiction is exactly what the paged layout removes
        return self._span

    def alloc(self, n_ctx: int, final_len: int,
              tokens: Optional[Sequence[int]] = None) -> Reservation:
        # dense lanes admit anything (writes past max_len clamp); capacity
        # is the lane count, which the engine bounds before calling alloc
        return Reservation()

    def prefill_paste(self, slot: int, group_cache: dict, src_lane: int, n_ctx: int,
                      width: int, res: Reservation) -> None:
        """Copy lane ``src_lane`` of a prefill cache into decode lane
        ``slot``, every leaf with a lane axis."""
        src = lane_leaves(group_cache, src_lane)
        for path, dst in lane_leaves(self.cache, slot).items():
            dst.copy_(src[path])

    def activate(self, slot: int, res: Reservation, n_ctx: int) -> None:
        raise NotImplementedError("dense lanes never produce full hits")

    def prepare_lane(self, slot: int) -> bool:
        return True

    def step(self, params, tokens, active: np.ndarray) -> torch.Tensor:
        """One decode step of every lane.  ``tokens`` is (B, 1) token ids, or
        on a stage after the first of a layer-split model the boundary
        hidden (B, 1, D): ids are cast to int64, floating inputs pass as
        they are; both go to the model's device."""
        x = torch.as_tensor(tokens)
        if not x.is_floating_point():
            x = x.to(torch.int64)
        out, self.cache = self.model.decode_step(params, self.cache, x.to(self.model.device))
        return out

    # -- speculative verify plumbing -----------------------------------
    def append_tokens(self, slot: int, toks: Sequence[int]) -> bool:
        return True          # lanes are max_len wide from the start

    def verify_step(self, params, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """W sequential decode steps; ``tokens`` (B, W) ids, returns the
        logits after each (B, W, Vp).  Every lane's position advances by W
        (an idle lane's garbage is reset by its next paste, as in ``step``)."""
        x = torch.as_tensor(tokens, dtype=torch.int64).to(self.model.device)
        out, self.cache = self.model.decode_state.window_step(params, self.cache, x)
        return out

    def rollback(self, slot: int, n: int) -> None:
        """Un-write the lane's last ``n`` positions.  K/V is addressed by
        position: moving ``pos`` back is enough, the stale entries are
        masked out of every read and overwritten by the next write."""
        if n <= 0:
            return
        if self.model.decode_state.kind == "recurrent":
            raise RuntimeError("dense lanes cannot roll back recurrent state; use "
                               "backend='recurrent'")
        self.cache["pos"][slot] -= n

    def reset_lane(self, slot: int) -> None:
        self.cache["pos"][slot] = 0

    def release(self, slot: int, tokens: Optional[Sequence[int]] = None) -> None:
        pass                 # lane garbage is overwritten by the next paste


class RecurrentBackend(DenseBackend):
    """Constant-footprint lanes for the recurrent families (rwkv, zamba2).

    A lane's state does not grow with its context: per layer the rwkv WKV
    and shift states or the Mamba2 conv tail and ssm state, plus zamba2's
    shared-block K/V slots.  ``token_footprint`` reports that fixed size
    (``state_units``, elements per lane over every leaf, ``pos`` included);
    every lane costs the same, so admission stays bound by the lane count.
    Preemption is where the layout pays: ``snapshot`` copies the lane to
    the host and a preempted request resumes from it with zero recompute."""

    name = "recurrent"
    snapshot_free = True

    def __init__(self, model: Model, n_lanes: int, max_len: int):
        super().__init__(model, n_lanes, max_len)
        self.state_units = sum(t.numel() for t in lane_leaves(self.cache, 0).values())
        # speculative rollback: a device copy of the pre-window cache, the
        # window's tokens (extended by the single steps taken after it) and
        # params, and the replayed caches memoised per kept length (lanes
        # rolling back the same amount after one round share one replay)
        self._stash: Optional[dict] = None
        self._stash_tokens: Optional[np.ndarray] = None
        self._stash_params = None
        self._replay_memo: Dict[int, dict] = {}
        self.replay_steps = 0        # single decode steps rollback replayed, in total

    def token_footprint(self, n_ctx: int, max_new: int,
                        tokens: Optional[Sequence[int]] = None) -> int:
        return self.state_units     # independent of prompt and generation length

    def step(self, params, tokens, active: np.ndarray) -> torch.Tensor:
        # single steps taken after a verify window (the draft side of a
        # speculative pair drafts this way) are part of the replayable
        # history; memoised prefixes stay valid, appending columns never
        # changes tokens[:, :keep]
        if self._stash_tokens is not None:
            self._stash_tokens = np.concatenate([self._stash_tokens, np.asarray(tokens)],
                                                axis=1)
        return super().step(params, tokens, active)

    @staticmethod
    def _clone(cache: dict) -> dict:
        """A copy of every leaf: the decode steps update the cache in place,
        so a stash or a replay must never share storage with another cache."""
        return {name: ({k: t.clone() for k, t in leaf.items()} if name == "layers"
                       else leaf.clone()) for name, leaf in cache.items()}

    @property
    def stash_bytes(self) -> int:
        """Bytes of the pre-window copy the last ``verify_step`` took."""
        if self._stash is None:
            return 0
        leaves = [*self._stash["layers"].values(),
                  *(t for name, t in self._stash.items() if name != "layers")]
        return sum(t.numel() * t.element_size() for t in leaves)

    def verify_step(self, params, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """The dense window, after stashing a device copy of the pre-window
        cache: rollback must rebuild the state as of any window prefix, and
        recurrent state cannot be un-written.  The copy is a ``clone`` on the
        cache's device (a few hundred MB at most, against a host round trip
        a round)."""
        self._stash = self._clone(self.cache)
        self._stash_tokens = np.asarray(tokens)
        self._stash_params = params
        self._replay_memo = {}
        return super().verify_step(params, tokens, active)

    def rollback(self, slot: int, n: int) -> None:
        """Rebuild the lane's state as of window position W - n: replay the
        kept prefix over the FULL multi-lane batch from a copy of the stash
        (one lane alone would change the step's shapes, and with them the
        rounding), memoised per kept length, then paste that one lane into
        the live cache.  A replay of ``keep`` steps is bitwise the first
        ``keep`` steps of the window: the same calls on the same state."""
        if n <= 0:
            return
        if self._stash is None:
            raise RuntimeError("rollback without a preceding verify_step")
        keep = self._stash_tokens.shape[1] - n
        if keep not in self._replay_memo:
            if keep <= 0:
                self._replay_memo[keep] = self._stash
            else:
                x = torch.as_tensor(self._stash_tokens[:, :keep],
                                    dtype=torch.int64).to(self.model.device)
                _, replayed = self.model.decode_state.window_step(
                    self._stash_params, self._clone(self._stash), x)
                self._replay_memo[keep] = replayed
                self.replay_steps += keep
        src = lane_leaves(self._replay_memo[keep], slot)
        for path, dst in lane_leaves(self.cache, slot).items():
            dst.copy_(src[path])

    def reset_lane(self, slot: int) -> None:
        for t in lane_leaves(self.cache, slot).values():
            t.zero_()

    def snapshot(self, slot: int) -> Dict[Tuple[str, ...], torch.Tensor]:
        """A host copy of the lane's every leaf.  The copies are synchronous:
        each is complete when it returns, so a later in-place decode step
        cannot change it."""
        return {path: t.to("cpu", copy=True)
                for path, t in lane_leaves(self.cache, slot).items()}

    def restore(self, slot: int, snap: Dict[Tuple[str, ...], torch.Tensor]) -> bool:
        for path, dst in lane_leaves(self.cache, slot).items():
            dst.copy_(snap[path])
        return True


class PagedBackend(CacheBackend):
    """Block-pooled KV with refcounted copy-on-write prefix caching.

    The pool (``model.decode_state.pool_init``) lives on the model's device
    and is updated in place; the block tables and lane positions are host
    numpy arrays, and the tables are uploaded into one device tensor of
    fixed shape ``(n_lanes, max_blocks_per_lane)`` before every step."""

    name = "paged"

    def __init__(self, model: Model, n_lanes: int, max_len: int, kv_blocks: int,
                 block_size: int, watermark_frac: float = 0.0, prefix_cache: bool = False):
        super().__init__(model, n_lanes, max_len)
        self.blocks = BlockManager(kv_blocks, block_size, watermark_frac)
        self.prefix_cache = prefix_cache
        self.max_blocks_per_lane = -(-max_len // block_size)
        self.cache = model.decode_state.pool_init(n_lanes, kv_blocks, block_size)
        self.block_tables = np.zeros((n_lanes, self.max_blocks_per_lane), np.int32)
        self._tables_dev = torch.zeros(self.block_tables.shape, dtype=torch.int32,
                                       device=model.device)
        self._lane_blocks: List[List[int]] = [[] for _ in range(n_lanes)]
        self._lane_pos = np.zeros((n_lanes,), np.int64)

    # -- gauges ---------------------------------------------------------
    @property
    def n_blocks(self) -> int:                           # type: ignore[override]
        return self.blocks.n_blocks

    @property
    def blocks_in_use(self) -> int:                      # type: ignore[override]
        return self.blocks.in_use

    @property
    def peak_blocks(self) -> int:                        # type: ignore[override]
        return self.blocks.peak_in_use

    @property
    def shared_blocks_peak(self) -> int:                 # type: ignore[override]
        return self.blocks.shared_peak

    @property
    def cow_splits(self) -> int:                         # type: ignore[override]
        return self.blocks.cow_splits

    @property
    def cache_evictions(self) -> int:                    # type: ignore[override]
        return self.blocks.evictions

    @property
    def state_version(self) -> int:                      # type: ignore[override]
        return self.blocks.version

    @property
    def budget_tokens(self) -> Optional[int]:
        bm = self.blocks
        return max(0, bm.free - bm.watermark_blocks) * bm.block_size

    @property
    def capacity_tokens(self) -> Optional[int]:
        bm = self.blocks
        return (bm.n_blocks - bm.watermark_blocks) * bm.block_size

    def reset_counters(self) -> None:
        bm = self.blocks
        bm.peak_in_use = bm.in_use
        bm.shared_peak = bm.shared_now
        bm.cow_splits = 0
        bm.evictions = 0

    def cached_prefix_tokens(self, tokens) -> int:
        if not self.prefix_cache or tokens is None:
            return 0
        return min(self.blocks.match_prefix(tokens).n_tokens, len(tokens))

    def forget_cache(self) -> int:
        return self.blocks.flush_cache()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def token_footprint(self, n_ctx: int, max_new: int,
                        tokens: Optional[Sequence[int]] = None) -> int:
        """Free-pool tokens this admission would consume NOW: blocks for
        the context, minus blocks already held live by other lanes (a
        refcount-zero cache hit still consumes a free block when revived,
        so only live-shared hits are discounted)."""
        bm = self.blocks
        need = bm.blocks_needed(n_ctx)
        if self.prefix_cache and tokens is not None:
            m = bm.match_prefix(tokens)
            need -= sum(1 for b in m.blocks if bm.ref_count(b) > 0)
        return need * bm.block_size

    def fits(self, n_ctx: int, final_len: int) -> bool:
        # feasibility is judged on the FINAL footprint: the context plus
        # every token the request may still generate.  Blocks freed by
        # prefix sharing don't relax this bound: COW can re-privatise every
        # shared block before the request completes.
        bm = self.blocks
        usable = bm.n_blocks - bm.watermark_blocks
        return final_len <= self.max_len and bm.blocks_needed(final_len) <= usable

    def alloc(self, n_ctx: int, final_len: int, tokens: Optional[Sequence[int]] = None):
        bm = self.blocks
        if not self.fits(n_ctx, final_len):
            return INFEASIBLE
        hits: List[int] = []
        n_cached = n_lookup = 0
        if self.prefix_cache and tokens is not None:
            m = bm.match_prefix(tokens)
            hits, n_cached, n_lookup = list(m.blocks), m.n_tokens, n_ctx
        need = bm.blocks_needed(n_ctx)
        fresh_n = need - len(hits)
        revived = sum(1 for b in hits if bm.ref_count(b) == 0)
        # admission charges only blocks the free pool actually loses: fresh
        # allocations plus revived cache hits; live-shared blocks ride along
        if not bm.can_admit(fresh_n + revived):
            return None
        for b in hits:
            bm.ref(b)        # BEFORE allocate(): hits must not be evicted
        fresh = bm.allocate(fresh_n) if fresh_n else []
        blocks = hits + fresh
        if self.prefix_cache and tokens is not None:
            # register the prompt's full blocks NOW (content arrives with
            # this round's paste, before any decode step reads it) so
            # same-round admissions already share them
            bm.register(blocks, tokens)
        full_hit = bool(self.prefix_cache and tokens is not None and n_cached >= n_ctx - 1)
        return Reservation(blocks=blocks, n_cached=n_cached, n_lookup=n_lookup,
                           full_hit=full_hit)

    def _flat_idx(self, blocks: List[int], n_cached: int, n_ctx: int,
                  width: int) -> np.ndarray:
        """Flattened pool rows for prefill positions 0..width-1: positions
        the lane must write go to its blocks; the pad tail AND the shared
        cached prefix (already holding identical K/V, and possibly read by
        other live lanes) go to the sink, so a shared block is never
        written."""
        bs = self.blocks.block_size
        i = np.arange(width)
        phys = (i % bs).astype(np.int64)               # sink by default
        mine = (i >= n_cached) & (i < n_ctx)
        ids = np.asarray(blocks, np.int64)
        phys[mine] = ids[i[mine] // bs] * bs + i[mine] % bs
        return phys

    def prefill_paste(self, slot: int, group_cache: dict, src_lane: int, n_ctx: int,
                      width: int, res: Reservation) -> None:
        """Scatter lane ``src_lane`` of a prefill cache into the lane's
        pool blocks and set its position, in place on the pool's device.
        Rows routed to the sink repeat (``index_copy_`` keeps one of the
        repeated writes): harmless, because no live lane reads the sink."""
        flat = torch.from_numpy(self._flat_idx(res.blocks, res.n_cached, n_ctx, width))
        flat = flat.to(self.model.device)
        for name in ("k", "v"):
            pool = self.cache["layers"][name]
            src = group_cache["layers"][name][:, src_lane, :width]
            pool.view(pool.shape[0], -1, *pool.shape[3:]).index_copy_(1, flat,
                                                                       src.to(pool.dtype))
        self.cache["pos"][slot] = n_ctx
        self._install(slot, res.blocks, n_ctx)

    def activate(self, slot: int, res: Reservation, n_ctx: int) -> None:
        """Full hit: every context position short of the last is cached.
        The lane starts at pos = n_ctx - 1 (set in place on the device) and
        its first decode step feeds the last context token -- no prefill."""
        self.cache["pos"][slot] = n_ctx - 1
        self._install(slot, res.blocks, n_ctx - 1)

    def _install(self, slot: int, blocks: List[int], pos: int) -> None:
        self._lane_blocks[slot] = list(blocks)
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :len(blocks)] = blocks
        self._lane_pos[slot] = pos

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def prepare_lane(self, slot: int) -> bool:
        """Make the lane's next write position safe: grow into a fresh
        block on a boundary, COW-split a shared block on first write (the
        block's K/V of every layer copied in place on the device), or
        uncache a sole-holder cached block whose content will diverge.
        False = pool exhausted (the engine preempts and retries)."""
        bm = self.blocks
        bidx = int(self._lane_pos[slot]) // bm.block_size
        if bidx >= self.max_blocks_per_lane:
            return True                  # saturated: dense-path clamp
        blocks = self._lane_blocks[slot]
        if bidx >= len(blocks):
            blk = bm.allocate_one()
            if blk is None:
                return False
            blocks.append(blk)
            self.block_tables[slot, bidx] = blk
            return True
        blk = blocks[bidx]
        if bm.ref_count(blk) > 1:
            fresh = bm.cow_split(blk)
            if fresh is None:
                return False
            for name in ("k", "v"):
                pool = self.cache["layers"][name]
                pool[:, fresh].copy_(pool[:, blk])
            blocks[bidx] = fresh
            self.block_tables[slot, bidx] = fresh
        elif bm.is_cached(blk):
            bm.uncache(blk)              # sole holder: write in place
        return True

    def step(self, params, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        # a copy from pageable host memory is complete when copy_ returns,
        # so the host tables may change again right after
        self._tables_dev.copy_(torch.from_numpy(self.block_tables))
        toks = torch.as_tensor(tokens, dtype=torch.int64).to(self.model.device)
        logits, self.cache = self.model.decode_state.pool_step(params, self.cache, toks,
                                                               self._tables_dev)
        self._lane_pos[active] += 1
        return logits

    # -- speculative verify plumbing -----------------------------------
    def append_tokens(self, slot: int, toks: Sequence[int]) -> bool:
        """Reserve write capacity for ``len(toks)`` consecutive positions:
        ``prepare_lane`` (grow / COW-split / uncache) once per position,
        crossing block boundaries as needed.  All or nothing: on exhaustion
        the position is restored and the engine preempts a victim and
        retries (blocks grown before the failure stay with the lane, which
        the window will reach anyway)."""
        pos0 = int(self._lane_pos[slot])
        for i in range(len(toks)):
            self._lane_pos[slot] = pos0 + i
            if not self.prepare_lane(slot):
                self._lane_pos[slot] = pos0
                return False
        self._lane_pos[slot] = pos0
        return True

    def verify_step(self, params, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """W sequential pooled decode steps over one upload of the block
        tables (``append_tokens`` reserved every position, so the tables
        hold still for the window); the logits after each (B, W, Vp)."""
        self._tables_dev.copy_(torch.from_numpy(self.block_tables))
        toks = torch.as_tensor(tokens, dtype=torch.int64).to(self.model.device)
        logits, self.cache = self.model.decode_state.pool_window_step(params, self.cache, toks,
                                                                      self._tables_dev)
        self._lane_pos[active] += toks.shape[1]
        return logits

    def rollback(self, slot: int, n: int) -> None:
        """Truncate the lane's last ``n`` writes and free the trailing blocks
        it no longer covers.  A round commits at least one token, so the new
        position lies past the pre-round content: every freed block is one
        this round grew or COW-privatised, never a shared or cached one."""
        if n <= 0:
            return
        bm = self.blocks
        new_pos = max(0, int(self._lane_pos[slot]) - n)
        self._lane_pos[slot] = new_pos
        self.cache["pos"][slot] = new_pos
        blocks = self._lane_blocks[slot]
        keep = bm.blocks_needed(new_pos)
        if len(blocks) > keep:
            tail = blocks[keep:]
            del blocks[keep:]
            bm.release(tail)
            self.block_tables[slot, keep:] = 0

    def reset_lane(self, slot: int) -> None:
        self.release(slot)
        self.cache["pos"][slot] = 0

    def release(self, slot: int, tokens: Optional[Sequence[int]] = None) -> None:
        blocks = self._lane_blocks[slot]
        if blocks:
            if self.prefix_cache and tokens is not None:
                n_valid = min(int(self._lane_pos[slot]), len(tokens))
                self.blocks.register(blocks, tokens[:n_valid])
            self.blocks.release(blocks)
        self._lane_blocks[slot] = []
        self.block_tables[slot, :] = 0
        self._lane_pos[slot] = 0


def make_backend(model: Model, n_lanes: int, max_len: int, config) -> CacheBackend:
    """Pick the backend for (model, engine config).

    ``config`` is the engine's :class:`~repro_torch.serving.engine.EngineConfig`.
    ``config.backend`` forces a layout (``"dense" | "paged" | "recurrent"``);
    the default ``None`` picks the block pool wherever the model has one and
    ``kv_blocks`` is set, recurrent lanes for the recurrent families (with
    or without ``kv_blocks``), dense lanes otherwise."""
    ds = model.decode_state
    choice = config.backend
    if choice is None:
        if config.kv_blocks is not None and ds.poolable:
            choice = "paged"
        elif ds.kind == "recurrent":
            choice = "recurrent"
        else:
            choice = "dense"
    if choice == "paged":
        if not ds.poolable:
            raise ValueError(f"{model.cfg.arch_id}: no pool-layout decode state; only "
                             f"full-attention K/V caches are pageable")
        if config.kv_blocks is None:
            raise ValueError("backend='paged' requires EngineConfig.kv_blocks")
        return PagedBackend(model, n_lanes, max_len, kv_blocks=config.kv_blocks,
                            block_size=config.kv_block_size,
                            watermark_frac=config.watermark_frac,
                            prefix_cache=config.prefix_cache)
    if choice == "recurrent":
        if ds.kind != "recurrent":
            raise ValueError(f"backend='recurrent' on a {ds.kind!r}-state family")
        return RecurrentBackend(model, n_lanes, max_len)
    if choice == "dense":
        return DenseBackend(model, n_lanes, max_len)
    raise ValueError(f"unknown backend {choice!r}")
