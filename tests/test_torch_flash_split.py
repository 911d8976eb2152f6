"""The split plan of flash's bf16 D = 64 body and its split-and-merge arithmetic.

``split_plan`` picks where the kernel cuts each CTA's live key range into
slices; ``cta_tiles`` and ``split_slices`` mirror the kernel's per-CTA
arithmetic (``csrc/flash_attention.cu``, ``flash_attention_d64``).  ``flash_attention_split_plain`` computes what the
kernel computes from those slices -- a softmax partial per slice, merged in
slice order -- and is held here to the JAX package's Pallas kernel (in
interpret mode) and its blockwise oracle.  The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels import flash_attention as kfa

F32_TOL = 3e-5      # fp32: same algorithm, sums in another order
H100_SMS = 132


def _live(q: int, tk: int, causal: bool, chunk: int) -> set:
    return {k for k in range(tk) if (not causal or k <= q) and
            (not chunk or q // chunk == k // chunk)}


@pytest.mark.parametrize("b,t,tk,h,g,causal,chunk,sms", [
    (1, 64, 1500, 12, 12, False, 0, H100_SMS),      # whisper's cross-attention
    (2, 17, 1500, 12, 12, False, 0, H100_SMS),
    (1, 65, 1500, 12, 12, True, 0, H100_SMS),
    (1, 200, 300, 8, 2, True, 48, 4),               # chunk edges inside query tiles
    (1, 130, 500, 4, 4, False, 48, 8),
    (1, 300, 100, 8, 2, True, 64, 6),               # query tiles with no live key
    (2, 77, 300, 14, 2, True, 0, 64),
    (1, 1, 1, 7, 1, True, 0, H100_SMS),
    (1, 1088, 1088, 14, 2, True, 0, H100_SMS),      # internvl2: no split
])
def test_split_slices_cover_each_cta_range_once(b, t, tk, h, g, causal, chunk, sms):
    n_split = kfa.split_plan(b, t, tk, h, g, causal, chunk, sms)
    assert n_split >= 1
    rows = 64 // kfa.heads_per_cta(h, g)
    tiles = kfa.cta_tiles(t, tk, causal, chunk, rows)
    assert len(tiles) == -(-t // rows)
    assert n_split == 1 or n_split <= max(n for _, n in tiles)
    for qt, (kt0, n_tiles) in enumerate(tiles):
        slices = kfa.split_slices(n_tiles, n_split)
        # the kernel's count of CTAs that take part, and its slice bounds
        per = -(-n_tiles // n_split) if n_tiles else 0
        assert len(slices) == (-(-n_tiles // per) if n_tiles else 1) <= n_split
        assert slices == [(s * per, min(n_tiles, s * per + per)) for s in range(len(slices))] \
            or n_tiles == 0
        assert kt0 % kfa.TILE == 0
        assert slices[0][0] == 0 and slices[-1][1] == n_tiles
        for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
            assert hi == lo2                             # contiguous, disjoint
        assert all(hi > lo for lo, hi in slices) or n_tiles == 0     # none empty
        # every live key of every row of the tile lies in exactly one slice
        seen = {}
        for lo, hi in slices:
            for key in range(kt0 + lo * kfa.TILE, min(tk, kt0 + hi * kfa.TILE)):
                seen[key] = seen.get(key, 0) + 1
        assert all(n == 1 for n in seen.values())
        live = set().union(*(_live(q, tk, causal, chunk)
                             for q in range(qt * rows, min(t, (qt + 1) * rows))))
        assert live <= set(seen)
        # and the slices hold no tile past the last live key
        if live:
            assert kt0 + (n_tiles - 1) * kfa.TILE <= max(live) and min(live) < kt0 + kfa.TILE
        else:
            assert n_tiles == 0


@pytest.mark.parametrize("what,b,t,tk,h,g,causal,split", [
    ("whisper cross, a 64-token prompt", 1, 64, 1500, 12, 12, False, True),
    ("whisper cross, a 37-token prompt", 2, 37, 1500, 12, 12, False, True),
    ("whisper encoder", 1, 1500, 1500, 12, 12, False, False),
    ("internvl2 prefill", 1, 1088, 1088, 14, 2, True, False),
    ("whisper training encoder", 4, 1500, 1500, 12, 12, False, False),
    ("whisper training decoder", 4, 448, 448, 12, 12, True, False),
    ("whisper training cross", 4, 448, 1500, 12, 12, False, False),
    ("whisper decoder, 64 tokens", 1, 64, 64, 12, 12, True, False),   # one key tile
])
def test_plan_splits_only_where_ctas_are_few(what, b, t, tk, h, g, causal, split):
    n_split = kfa.split_plan(b, t, tk, h, g, causal, 0, H100_SMS)
    units = kfa.d64_units(b, t, h, g)
    assert (n_split > 1) == split, (what, n_split)
    if split:
        assert units < H100_SMS and units * n_split <= H100_SMS
    if what == "whisper cross, a 64-token prompt":
        assert n_split == 8                              # 24 tiles in 8 slices of 3


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,tk,h,g,causal,chunk", [
    (1, 300, 7, 1, False, 0),           # H/G 7
    (37, 300, 7, 1, False, 0),
    (64, 300, 14, 2, False, 0),         # H/G 7 over two KV heads
    (64, 300, 7, 1, False, 48),         # chunked: two tiles, two slices
    (5, 250, 2, 2, False, 0),           # H/G 1
    (64, 129, 2, 2, False, 64),
    (64, 300, 7, 1, True, 0),           # causal: one key tile, no split
    (17, 200, 2, 2, True, 48),
])
def test_split_plain_matches_jax(t, tk, h, g, causal, chunk):
    q, k, v = _normal(0, (1, t, h, 64)), _normal(1, (1, tk, g, 64)), _normal(2, (1, tk, g, 64))
    n_split = kfa.split_plan(1, t, tk, h, g, causal, chunk, H100_SMS)
    assert n_split > 1 or causal or chunk == 64        # the split is what is checked
    out = kfa.flash_attention_split_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                          causal=causal, chunk=chunk, n_sms=H100_SMS)
    kern = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               chunk=chunk, interpret=True)
    oracle = kref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, chunk=chunk)
    for ref in (kern, oracle):
        assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < F32_TOL
