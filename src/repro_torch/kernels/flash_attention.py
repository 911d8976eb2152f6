"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``; each CTA holds a
query tile and streams past it the K/V tiles that any of its rows can see.
bf16 runs two Hopper bodies, each a TMA ring of K/V tiles fed by a producer
and consumed on ``wgmma``, the query heads of one KV head sharing a staged
tile.  At head_dim 112 and 128 (granite-8b, zamba2-7b) a CTA is two
consumer warpgroups.  At 64 (whisper-small, internvl2-1b) a CTA is one, three
to an SM, and its units are handed out longest first.  Prefill there is
bound by operations (the softmax's exponentials as much as the products);
whisper's cross-attention at a short prompt by bytes (a stream over 1500
frames of K/V for 12 query tiles), and there :func:`split_plan` cuts each
unit's key range into slices whose partials the last CTA merges
(:func:`split_slices`; :func:`flash_attention_split_plain` is that
arithmetic in plain PyTorch).  bf16 at 32 keeps ``mma.sync``, fp32 scalar
FMA.  The wrapper hands the kernel q, k and v as they are: no copy, no
padding.  :func:`flash_attention_plain` ports the blockwise oracle
``repro/models/flash_ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dec

# kernel launches made by flash_attention_cuda in this process
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)   # 112: zamba2-7b's shared block
TILE = 64                        # keys a K/V tile of the D = 64 body (csrc D64_BK)
PART_FLOATS = 9 * 4 * 128        # fp32 a split unit leaves in a slot (csrc D64_PART_F4)

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float,)
         + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3)


def heads_per_cta(h: int, g: int) -> int:
    """The query heads of one KV head that share the D = 64 body's 64 rows:
    the largest of 4, 2, 1 that divides H / G (csrc launch_d64)."""
    rep = h // g
    return 4 if rep % 4 == 0 else 2 if rep % 2 == 0 else 1


def key_bounds(q: int, tk: int, causal: bool, chunk: int) -> Tuple[int, int]:
    """The keys [lo, hi) query position ``q`` sees (csrc key_range)."""
    lo = (q // chunk) * chunk if chunk else 0
    hi = tk
    if causal:
        hi = min(hi, q + 1)
    if chunk:
        hi = min(hi, lo + chunk)
    return lo, hi


def cta_tiles(t: int, tk: int, causal: bool, chunk: int, rows: int) -> List[Tuple[int, int]]:
    """(first key, tiles) of each query tile of ``rows`` positions: the
    ``TILE``-key tiles, from the one holding its first row's first live
    key, that cover every live key of its rows."""
    out = []
    for q0 in range(0, t, rows):
        k_lo = key_bounds(q0, tk, causal, chunk)[0]
        k_hi = key_bounds(min(q0 + rows, t) - 1, tk, causal, chunk)[1]
        kt0 = k_lo // TILE * TILE
        out.append((kt0, -(-(k_hi - kt0) // TILE) if k_hi > kt0 else 0))
    return out


def split_slices(n_tiles: int, n_split: int) -> List[Tuple[int, int]]:
    """The tile ranges [lo, hi) into which a CTA's ``n_tiles`` live tiles
    are cut: ``ceil(n_tiles / n_split)`` tiles each, the last shorter, none
    empty (the kernel's CTAs past the last exit at once).  A CTA with no live
    tile keeps one empty slice, which writes its zeros."""
    if n_tiles == 0:
        return [(0, 0)]
    per = -(-n_tiles // n_split)
    return [(lo, min(n_tiles, lo + per)) for lo in range(0, n_tiles, per)]


def d64_units(b: int, t: int, h: int, g: int) -> int:
    """The D = 64 body's (query tile, head group, batch) units: its CTAs
    when nothing is split."""
    nh = heads_per_cta(h, g)
    return -(-t // (64 // nh)) * (h // nh) * b


def split_plan(b: int, t: int, tk: int, h: int, g: int, causal: bool, chunk: int,
               n_sms: int) -> int:
    """Slices of each unit's live key range for the D = 64 body: where the
    units are fewer than the SMs, ``n_sms // units`` (never more than its
    tiles), else 1.  Returned as the count the longest range needs, so no
    CTA of the grid is left without a slice.  Cutting for two CTAs an SM
    instead measured slower on the H100 (PERF.md)."""
    units = d64_units(b, t, h, g)
    if units >= n_sms:
        return 1
    tiles = max(n for _, n in cta_tiles(t, tk, causal, chunk, 64 // heads_per_cta(h, g)))
    if tiles == 0:
        return 1
    per = -(-tiles // min(tiles, n_sms // units))
    return -(-tiles // per)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          chunk: int = 0, block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,Tk,G,D) with H % G == 0.  Returns (B,T,H,D).

    Blockwise online softmax over (Q-block, KV-block) tiles with running
    (m, l, acc) in fp32, GQA without repeating K/V; the same arithmetic as
    the reference oracle, including its causal block limit."""
    b, t, h, d = q.shape
    tk, g = k.shape[1], k.shape[2]
    nrep = h // g
    scale = d ** -0.5 if scale is None else scale
    block_q = min(block_q, t)
    block_k = min(block_k, tk)
    dev = q.device
    qg = q.reshape(b, t, g, nrep, d).permute(0, 2, 3, 1, 4)       # (B,G,R,T,D)
    kg = k.permute(0, 2, 1, 3)                                      # (B,G,Tk,D)
    vg = v.permute(0, 2, 1, 3)
    out = torch.empty((b, g, nrep, t, d), dtype=q.dtype, device=dev)
    nk = -(-tk // block_k)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for q0 in range(0, t, block_q):
        qt = qg[:, :, :, q0:q0 + block_q]
        m = torch.full(qt.shape[:-1], float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=dev)
        qpos = torch.arange(q0, q0 + qt.shape[3], device=dev)
        nkv = nk
        if causal and not chunk:
            nkv = min(nk, (q0 // block_q + 1) * block_q // block_k + 1)
        for k0 in range(0, nkv * block_k, block_k):
            kt, vt = kg[:, :, k0:k0 + block_k], vg[:, :, k0:k0 + block_k]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qt, kt).float() * scale
            kpos = torch.arange(k0, k0 + kt.shape[2], device=dev)
            mask = (kpos < tk)[None, :].expand(qpos.shape[0], kpos.shape[0])
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if chunk:
                mask = mask & ((qpos[:, None] // chunk) == (kpos[None, :] // chunk))
            s = torch.where(mask, s, neg)
            mnew = torch.maximum(m, s.amax(-1))
            dead = torch.isinf(mnew)
            msafe = torch.where(dead, zero, mnew)
            p = torch.where(dead[..., None], zero, torch.exp(s - msafe[..., None]))
            corr = torch.where(torch.isinf(m), zero, torch.exp(m - msafe))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p.to(vt.dtype), vt).float()
            m = mnew
        lsafe = torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, :, q0:q0 + block_q] = (acc / lsafe[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                causal: bool = True, scale: Optional[float] = None,
                                chunk: int = 0, n_sms: int = 132) -> torch.Tensor:
    """What the bf16 D = 64 body computes, in plain PyTorch and fp32: its
    query tiles, each one's live key tiles cut as :func:`split_plan` and
    :func:`split_slices` cut them, a softmax partial (m, l, O) over each
    slice with masked scores at -inf (a row with no live key in a slice
    adds nothing), and the partials merged in slice order; a row with no
    live key at all returns 0.  Same contract as
    :func:`flash_attention_plain`."""
    b, t, h, d = q.shape
    tk, g = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    n_split = split_plan(b, t, tk, h, g, causal, chunk, n_sms)
    rows = 64 // heads_per_cta(h, g)
    dev = q.device
    kr = k.repeat_interleave(h // g, dim=2).float()                  # (B,Tk,H,D)
    vr = v.repeat_interleave(h // g, dim=2)
    qpos, kpos = torch.arange(t, device=dev)[:, None], torch.arange(tk, device=dev)[None]
    live = torch.ones((t, tk), dtype=torch.bool, device=dev)
    if causal:
        live = live & (kpos <= qpos)
    if chunk:
        live = live & (qpos // chunk == kpos // chunk)
    zero = torch.zeros((), device=dev)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    for qt, (kt0, n_tiles) in enumerate(cta_tiles(t, tk, causal, chunk, rows)):
        rs = slice(qt * rows, min(t, (qt + 1) * rows))
        qf = q[:, rs].float()
        m = torch.full(qf.shape[:-1], float("-inf"), device=dev)     # (B,rows,H)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for lo, hi in split_slices(n_tiles, n_split):
            ks = slice(kt0 + lo * TILE, min(tk, kt0 + hi * TILE))
            s = torch.einsum("bqhd,bkhd->bqhk", qf, kr[:, ks]) * scale
            s = torch.where(live[rs, ks][None, :, None, :], s, float("-inf"))
            ms = s.amax(-1) if s.shape[-1] else torch.full_like(m, float("-inf"))
            p = torch.exp(s - torch.where(torch.isinf(ms), zero, ms)[..., None])
            ls = p.sum(-1)
            os = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype), vr[:, ks]).float()
            mn = torch.maximum(m, ms)
            base = torch.where(torch.isinf(mn), zero, mn)
            c = torch.where(torch.isinf(m), zero, torch.exp(m - base))
            w = torch.where(torch.isinf(ms), zero, torch.exp(ms - base))
            l = l * c + ls * w
            acc = acc * c[..., None] + os * w[..., None]
            m = mn
        out[:, rs] = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).to(q.dtype)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, scale: Optional[float] = None,
                         chunk: int = 0) -> torch.Tensor:
    """Same contract as :func:`flash_attention_plain`, on a CUDA device."""
    global launches
    b, t, h, d = q.shape
    tk, g = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in _DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(k.shape) != (b, tk, g, d) or tuple(v.shape) != (b, tk, g, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS or g == 0 or h % g:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS} and H % G == 0; "
                         f"got D={d}, H={h}, G={g}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention_cuda needs 16-byte aligned q, k, v")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    if tk == 0:
        return out.zero_()
    stream = _build.stream(dev)
    n_sms = _dec.n_sms(dev)
    n_split = 1
    part = counters = None
    if d == 64 and q.dtype == torch.bfloat16:
        n_split = split_plan(b, t, tk, h, g, causal, chunk, n_sms)
        if n_split > 1:
            units = d64_units(b, t, h, g)
            _, _, part, counters = _dec.scratch(dev, stream, units * n_split, PART_FLOATS, units)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, tk, h,
                    g, d, int(causal), int(chunk), scale, _DT[q.dtype], n_split, n_sms, part,
                    counters, stream), "flash_attention_fwd")
    launches += 1
    return out
