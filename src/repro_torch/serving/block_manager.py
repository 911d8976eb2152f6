"""Paged KV-cache block accounting for the serving engine (a copy of
``repro/serving/block_manager.py``: same behaviour, same counters).

The KV pool is a fixed set of fixed-size blocks (``block_size`` token
positions each, all layers ride together in the model-side pool arrays);
a lane's cache is the ordered list of blocks in its block table, so
admission capacity is bound by *live tokens*, not by lanes times the
worst-case sequence length.

Block id 0 is RESERVED as the sink: free decode lanes and right-pad
positions scatter their garbage writes there, so the manager hands out
ids ``1..n_blocks`` only.

Watermark: ``can_admit`` keeps ``watermark_blocks`` free blocks in
reserve for decode-time growth of already-running lanes — admitting up
to the last block converts every subsequent grow into a preemption.
Growth allocation (``allocate_one``) ignores the watermark; running
requests always get priority over queued ones.

Prefix caching (copy-on-write sharing)
--------------------------------------

Every block is REFCOUNTED.  A full block whose token content is known can
be *registered* in a content-addressed cache keyed by the chained digest
of everything up to and including the block (position matters: the same
16 tokens after a different prefix hold different K/V).  A later request
whose prompt starts with the same token prefix *matches* those blocks and
shares them (`ref`) instead of allocating + recomputing:

* blocks shared by live lanes carry ``ref_count >= 2`` and are immutable;
  a lane whose next write lands inside a shared block must `cow_split`
  first (the engine copies the device content old -> new).
* a released block whose refcount reaches zero stays CACHED but joins the
  free pool; allocation prefers never-cached blocks and only then evicts
  cached ones, least recently used first, so idle cache survives as long
  as memory pressure allows.
* a sole-holder (``ref_count == 1``) cached block about to be written
  diverges from its registered content and must be `uncache`d instead of
  split — reuse without a copy.

``match_prefix`` is a pure query (no refcounts taken); admission decides
what it can afford, then takes hits with `ref` BEFORE allocating fresh
blocks, so the allocator cannot evict the very blocks being matched.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple


def _chain_key(parent: Optional[bytes], chunk: Sequence[int]) -> bytes:
    """Digest of a full block's content, chained through its prefix."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent or b"\x00")
    h.update(b",".join(str(int(t)).encode() for t in chunk))
    return h.digest()


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of a prefix-cache lookup (pure; nothing is reserved)."""

    blocks: Tuple[int, ...]  # cached blocks covering the prefix, in order
    n_tokens: int  # token positions covered (last block may be partial)
    tail_partial: bool  # last matched block is only prefix-matched


class BlockManager:
    """Refcounting free-list allocator over ``n_blocks`` usable KV blocks."""

    def __init__(self, n_blocks: int, block_size: int, watermark_frac: float = 0.0):
        if n_blocks < 1:
            raise ValueError(f"need at least one usable block, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if not 0.0 <= watermark_frac < 1.0:
            raise ValueError(f"watermark_frac must be in [0, 1), got {watermark_frac}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.watermark_blocks = int(watermark_frac * n_blocks)
        # LIFO free list of never-cached blocks: recently freed reused first
        self._free_plain: List[int] = list(range(n_blocks, 0, -1))
        # refcount == 0 but content still registered; OrderedDict as an LRU
        # (oldest first) so eviction keeps the hottest cache entries alive
        self._free_cached: "OrderedDict[int, None]" = OrderedDict()
        self._ref: Dict[int, int] = {}  # allocated block -> refcount
        # content cache: block -> (chain key, tokens); inverse + parent index
        self._key_of: Dict[int, bytes] = {}
        self._tokens_of: Dict[int, Tuple[int, ...]] = {}
        self._parent_of: Dict[int, Optional[bytes]] = {}
        self._by_key: Dict[bytes, int] = {}
        self._by_parent: Dict[Optional[bytes], Set[int]] = {}
        self.peak_in_use = 0
        self.alloc_count = 0
        self.free_count = 0
        # prefix-cache / sharing gauges
        self.shared_now = 0  # blocks with ref_count >= 2
        self.shared_peak = 0
        self.cow_splits = 0
        self.evictions = 0
        # bumped on every mutation that can change a prefix-match or a
        # refcount — lets callers memoize match-derived quantities (e.g.
        # admission footprints) instead of re-hashing prompts every step
        self.version = 0

    # ------------------------------------------------------------------
    @property
    def free(self) -> int:
        return len(self._free_plain) + len(self._free_cached)

    @property
    def in_use(self) -> int:
        return self.n_blocks - self.free

    @property
    def utilization(self) -> float:
        return self.in_use / self.n_blocks

    @property
    def cached_blocks(self) -> int:
        return len(self._key_of)

    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` cache positions (at least one)."""
        return max(1, -(-n_tokens // self.block_size))

    def can_admit(self, n: int) -> bool:
        """Whether ``n`` blocks may go to a NEW request (watermark applies).

        ``n`` must count every free block the admission will consume: fresh
        allocations AND refcount-zero cache hits it revives.
        """
        return self.free - n >= self.watermark_blocks

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_cached(self, block: int) -> bool:
        return block in self._key_of

    # ------------------------------------------------------------------
    # allocation / refcounting
    # ------------------------------------------------------------------
    def _track_shared(self, before: int, after: int) -> None:
        if before < 2 <= after:
            self.shared_now += 1
            self.shared_peak = max(self.shared_peak, self.shared_now)
        elif after < 2 <= before:
            self.shared_now -= 1

    def allocate(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh blocks (no watermark), or None without side
        effects.  Prefers never-cached blocks; evicts cached free blocks
        (LRU) only when it must, dropping their registrations."""
        if n > self.free:
            return None
        taken: List[int] = []
        for _ in range(n):
            if self._free_plain:
                b = self._free_plain.pop()
            else:
                b, _ = self._free_cached.popitem(last=False)  # LRU
                self._forget(b)
                self.evictions += 1
            self._ref[b] = 1
            taken.append(b)
        self.alloc_count += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return taken

    def allocate_one(self) -> Optional[int]:
        got = self.allocate(1)
        return got[0] if got else None

    def ref(self, block: int) -> None:
        """Take a share of a block: a live one (refcount += 1) or a cached
        free one (revived out of the free pool at refcount 1)."""
        self.version += 1
        rc = self._ref.get(block)
        if rc is not None:
            self._ref[block] = rc + 1
            self._track_shared(rc, rc + 1)
            return
        if block not in self._free_cached:
            raise ValueError(f"block {block} is neither live nor cached-free")
        del self._free_cached[block]
        self._ref[block] = 1
        self.alloc_count += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block.  A refcount reaching zero returns
        the block to the free pool — still registered, so a later request
        with the same prefix can revive it.  Over-release is rejected at
        the offending call, BEFORE any refcount moves — handing one
        physical block back twice would later alias two lanes' KV writes."""
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in release: {blocks}")
        for b in blocks:
            if not 1 <= b <= self.n_blocks:
                raise ValueError(f"block id {b} outside the usable range")
            if b not in self._ref:
                raise ValueError(f"double free: block {b} is not allocated")
        self.version += 1
        for b in blocks:
            rc = self._ref[b] - 1
            self._track_shared(rc + 1, rc)
            if rc:
                self._ref[b] = rc
                continue
            del self._ref[b]
            if b in self._key_of:
                self._free_cached[b] = None  # MRU end of the LRU order
            else:
                self._free_plain.append(b)
            self.free_count += 1

    def cow_split(self, block: int) -> Optional[int]:
        """Copy-on-write: give the caller a private block in place of a
        SHARED one it is about to write.  Allocates the replacement, drops
        one reference on the original (which keeps its content and its
        cache entry), and returns the new id — the caller must copy the
        device-side content and patch its block table.  None (no side
        effects) when the pool is exhausted."""
        if self._ref.get(block, 0) < 2:
            raise ValueError(f"cow_split of unshared block {block}")
        fresh = self.allocate_one()
        if fresh is None:
            return None
        rc = self._ref[block]
        self._ref[block] = rc - 1
        self._track_shared(rc, rc - 1)
        self.cow_splits += 1
        return fresh

    # ------------------------------------------------------------------
    # content cache
    # ------------------------------------------------------------------
    def _forget(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is None:
            return
        self.version += 1
        self._tokens_of.pop(block, None)
        self._by_key.pop(key, None)
        parent = self._parent_of.pop(block, None)
        peers = self._by_parent.get(parent)
        if peers is not None:
            peers.discard(block)
            if not peers:
                del self._by_parent[parent]

    def flush_cache(self) -> int:
        """Forget EVERY content registration (a zombie worker rejoining
        after a reboot has cold memory: content-addressed hits against
        its old registrations would serve garbage K/V).  Refcount-zero
        cached blocks return to the plain free pool; blocks still held
        by live lanes stay allocated but leave the match index.  Returns
        the number of registrations dropped."""
        dropped = 0
        while self._free_cached:
            b, _ = self._free_cached.popitem(last=False)
            self._forget(b)
            self._free_plain.append(b)
            dropped += 1
        for b in list(self._key_of):     # still-referenced registrations
            self._forget(b)
            dropped += 1
        return dropped

    def uncache(self, block: int) -> None:
        """Drop a block's registration because its content is about to
        diverge (sole-holder write into a revived cached block)."""
        if self._ref.get(block, 0) != 1:
            raise ValueError(f"uncache of block {block} with refcount != 1")
        self._forget(block)

    def register(self, blocks: Sequence[int], tokens: Sequence[int]) -> int:
        """Enter every FULL block of ``tokens`` into the content cache.

        ``blocks`` is the lane's block table prefix and ``tokens`` the
        token content actually written through it; the trailing partial
        block (if any) is ignored.  Blocks already registered, or whose
        key is already held by another block, are skipped (first writer
        stays canonical).  Returns how many new entries were made."""
        bs = self.block_size
        parent: Optional[bytes] = None
        added = 0
        for i in range(len(tokens) // bs):
            b = blocks[i]
            chunk = tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            key = _chain_key(parent, chunk)
            if b in self._key_of:
                # consistent re-registration keeps the existing entry; a
                # CHANGED key means the block was rewritten while cached —
                # a bookkeeping bug upstream, not a cache policy choice
                if self._key_of[b] != key:
                    raise ValueError(f"block {b} re-registered with new content")
            elif key not in self._by_key:
                self.version += 1
                self._key_of[b] = key
                self._tokens_of[b] = chunk
                self._parent_of[b] = parent
                self._by_key[key] = b
                self._by_parent.setdefault(parent, set()).add(b)
                added += 1
            parent = key
        return added

    def match_prefix(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (pure query, no refs).

        Full ``block_size`` chunks match by chained digest; when EVERY
        full chunk matched, the trailing partial chunk may additionally
        match the head of a cached block (``tail_partial`` — the caller
        shares that block and must COW before its first write into it)."""
        bs = self.block_size
        out: List[int] = []
        parent: Optional[bytes] = None
        n = 0
        n_full = len(tokens) // bs
        for i in range(n_full):
            chunk = tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            key = _chain_key(parent, chunk)
            b = self._by_key.get(key)
            if b is None:
                return PrefixMatch(tuple(out), n, False)
            out.append(b)
            parent = key
            n += bs
        rem = len(tokens) - n_full * bs
        if rem:
            tail = tuple(int(t) for t in tokens[n_full * bs :])
            for b in self._by_parent.get(parent, ()):
                if self._tokens_of[b][:rem] == tail:
                    out.append(b)
                    return PrefixMatch(tuple(out), n + rem, True)
        return PrefixMatch(tuple(out), n, False)
