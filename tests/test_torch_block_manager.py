"""The port's BlockManager against the JAX package's, operation by operation.

A seeded random trace of allocate / allocate_one / ref / release /
register / match_prefix / cow_split / uncache / flush_cache drives both
managers; after every operation the return values (or the exceptions), the
free lists, refcounts, content index and counters must be exactly equal.
The block-level cases of tests/test_paged.py and tests/test_prefix_cache.py
run on both classes, whose states must then be equal too.
"""
import numpy as np
import pytest

from repro.serving.block_manager import BlockManager as JaxBlockManager
from repro_torch.serving.block_manager import BlockManager


def _state(m):
    return (list(m._free_plain), list(m._free_cached), dict(m._ref), dict(m._key_of),
            dict(m._tokens_of), dict(m._parent_of), dict(m._by_key),
            {k: sorted(v) for k, v in m._by_parent.items()},
            m.peak_in_use, m.alloc_count, m.free_count, m.shared_now, m.shared_peak,
            m.cow_splits, m.evictions, m.version, m.free, m.in_use, m.cached_blocks)


def _call(m, op, args):
    try:
        out = getattr(m, op)(*args)
    except ValueError as e:
        return ("ValueError", str(e))
    if hasattr(out, "n_tokens"):                      # PrefixMatch of either package
        return (tuple(out.blocks), out.n_tokens, out.tail_partial)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_trace_matches_reference_exactly(seed):
    rng = np.random.default_rng(seed)
    bs = int(rng.choice([2, 4]))
    n_blocks = int(rng.integers(4, 12))
    port = BlockManager(n_blocks, bs, watermark_frac=0.25)
    ref = JaxBlockManager(n_blocks, bs, watermark_frac=0.25)
    # prompts are prefixes of a few documents over a tiny vocabulary, so
    # registrations and prefix matches hit each other
    docs = [rng.integers(0, 3, size=6 * bs) for _ in range(3)]
    held = []                                        # one entry per reference we own
    for _ in range(400):
        op = rng.choice(["allocate", "allocate_one", "ref", "release", "register",
                         "match_prefix", "cow_split", "uncache", "flush_cache"],
                        p=[.16, .1, .12, .18, .14, .14, .08, .04, .04])
        if op == "allocate":
            args = (int(rng.integers(0, 4)),)
        elif op == "ref":
            pool = sorted(set(port._ref) | set(port._free_cached)) or [1]
            args = (int(rng.choice(pool + [n_blocks])),)     # sometimes an invalid id
        elif op == "release":
            distinct = sorted(set(held))
            k = int(rng.integers(0, len(distinct) + 1))
            args = ([int(b) for b in rng.permutation(distinct)[:k]],)
            if rng.random() < 0.05 and distinct:
                args = ([distinct[0], distinct[0]],)          # duplicate: rejected
        elif op == "register":
            blocks = [int(b) for b in rng.permutation(sorted(set(held)))]
            n_tok = int(rng.integers(0, len(blocks) * bs + 1))
            args = (blocks, docs[int(rng.integers(3))][:n_tok])
        elif op == "match_prefix":
            args = (docs[int(rng.integers(3))][:int(rng.integers(0, 6 * bs + 1))],)
        elif op in ("cow_split", "uncache"):
            args = (int(rng.choice(held)) if held else 1,)
        else:
            args = ()
        got, want = _call(port, op, args), _call(ref, op, args)
        assert got == want, (op, args)
        assert _state(port) == _state(ref), (op, args)
        if isinstance(got, tuple) and got and got[0] == "ValueError":
            continue
        if op == "allocate" and got:
            held += got
        elif op == "allocate_one" and got is not None:
            held.append(got)
        elif op == "ref":
            held.append(args[0])
        elif op == "release":
            for b in args[0]:
                held.remove(b)
        elif op == "cow_split" and got is not None:
            held.remove(args[0])
            held.append(got)
    assert port.alloc_count > 0 and port.free_count > 0


def _case_block_manager_alloc_release_watermark(BM):
    m = BM(8, block_size=4, watermark_frac=0.25)
    assert m.blocks_needed(1) == 1 and m.blocks_needed(4) == 1
    assert m.blocks_needed(5) == 2 and m.blocks_needed(0) == 1
    a = m.allocate(3)
    assert len(a) == 3 and all(1 <= b <= 8 for b in a)      # 0 is the sink
    assert m.in_use == 3 and m.free == 5 and m.peak_in_use == 3
    assert m.can_admit(3) and not m.can_admit(4)             # 2 held back for growth
    assert m.allocate(6) is None and m.in_use == 3           # no side effects
    b = m.allocate(5)                                        # growth ignores it
    assert len(b) == 5 and m.free == 0 and m.peak_in_use == 8
    m.release(a)
    assert m.free == 3 and m.in_use == 5
    with pytest.raises(ValueError):
        m.release([0])                                       # sink is unmanaged
    with pytest.raises(ValueError):
        m.release([a[0]])                                    # double free
    with pytest.raises(ValueError):
        m.release([b[0], b[0]])                              # dup in one call
    assert m.free == 3
    with pytest.raises(ValueError):
        BM(0, 4)
    return m


def _case_refcount_share_and_staged_release(BM):
    m = BM(6, block_size=4)
    a = m.allocate(2)
    m.ref(a[0])
    assert m.ref_count(a[0]) == 2 and m.shared_now == 1
    m.release(a)
    assert m.ref_count(a[0]) == 1 and m.in_use == 1 and m.shared_now == 0
    m.release([a[0]])
    assert m.in_use == 0 and m.free == 6
    return m


def _case_double_release_of_shared_block_rejected(BM):
    m = BM(4, block_size=4)
    a = m.allocate(1)
    m.ref(a[0])
    m.release(a)
    m.release(a)
    with pytest.raises(ValueError):
        m.release(a)
    with pytest.raises(ValueError):
        m.release([a[0], a[0]])
    return m


def _case_cow_split_allocates_and_derefs(BM):
    m = BM(4, block_size=4)
    a = m.allocate(1)
    m.ref(a[0])
    fresh = m.cow_split(a[0])
    assert fresh is not None and fresh != a[0]
    assert m.ref_count(a[0]) == 1 and m.ref_count(fresh) == 1
    assert m.cow_splits == 1
    with pytest.raises(ValueError):
        m.cow_split(a[0])
    return m


def _case_cow_split_under_pressure_returns_none_without_side_effects(BM):
    m = BM(2, block_size=4)
    a = m.allocate(2)
    m.ref(a[0])
    assert m.cow_split(a[0]) is None
    assert m.ref_count(a[0]) == 2 and m.cow_splits == 0
    return m


def _case_register_match_revive_and_evict(BM):
    m = BM(3, block_size=4)
    toks = np.arange(10)
    blocks = m.allocate(3)
    assert m.register(blocks, toks) == 2
    full = m.match_prefix(np.arange(8))
    assert list(full.blocks) == blocks[:2] and full.n_tokens == 8
    part = m.match_prefix(np.arange(6))
    assert part.n_tokens == 6 and part.tail_partial
    assert list(part.blocks) == blocks[:2]
    assert m.match_prefix(np.array([9, 9, 9, 9, 4, 5])).n_tokens == 0
    m.release(blocks)
    assert m.match_prefix(np.arange(8)).n_tokens == 8
    m.ref(blocks[0])
    assert m.ref_count(blocks[0]) == 1
    got = m.allocate(2)
    assert m.evictions == 1 and set(got) == set(blocks[1:])
    assert m.match_prefix(np.arange(8)).n_tokens == 4
    m.uncache(blocks[0])
    assert m.match_prefix(np.arange(8)).n_tokens == 0
    return m


def _case_reregistration_must_be_consistent(BM):
    m = BM(3, block_size=2)
    blocks = m.allocate(2)
    m.register(blocks, np.array([1, 2, 3, 4]))
    m.register(blocks, np.array([1, 2, 3, 4]))
    with pytest.raises(ValueError):
        m.register(blocks, np.array([5, 6, 7, 8]))
    return m


def _case_flush_cache_forgets_every_registration(BM):
    m = BM(4, block_size=2)
    blocks = m.allocate(3)
    m.register(blocks, np.arange(6))
    m.release(blocks[:2])                          # two cached-free, one still held
    assert m.flush_cache() == 3
    assert m.cached_blocks == 0 and m.match_prefix(np.arange(6)).n_tokens == 0
    assert m.ref_count(blocks[2]) == 1 and m.free == 3
    return m


CASES = [_case_block_manager_alloc_release_watermark, _case_refcount_share_and_staged_release,
         _case_double_release_of_shared_block_rejected, _case_cow_split_allocates_and_derefs,
         _case_cow_split_under_pressure_returns_none_without_side_effects,
         _case_register_match_revive_and_evict, _case_reregistration_must_be_consistent,
         _case_flush_cache_forgets_every_registration]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[len("_case_"):])
def test_reference_case_on_both_managers(case):
    assert _state(case(BlockManager)) == _state(case(JaxBlockManager))
