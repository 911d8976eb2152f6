"""Chunked WKV6 recurrence: the Hopper kernel's wrapper and its plain version.

The kernel (``csrc/rwkv6_scan.cu``) replaces the TPU kernel
``repro/kernels/rwkv6_scan.py::rwkv6_chunked_fwd``.  bf16 inputs take its
tensor-core body: a CTA per (batch, head) walks chunks of 64 in sub-blocks
of 16, its warps splitting the rows and the two halves of V, the pairs
across sub-blocks (and across the 8-token halves of one) through products
of decay-scaled r and k about a reference point between them, the chunk
products on mma.sync with the fp32 operands split into hi + lo bf16 terms.
fp32 inputs (the parity runs) take a scalar body, one CTA per (batch, head)
and chunks of 16.

Neither version forms a positive exponent: the plain version takes the
intra-chunk decay ratio ``e^{La_{t-1} - La_s}`` (``s < t``) pairwise, the
kernel pairwise or as two factors ``<= 1`` about a reference point between
``s`` and ``t - 1``.  The TPU kernel's ``k * e^{-La}`` factor overflows fp32 once a chunk's
log-decay sum passes about -88 (a per-step log-decay of -1.5 over its
64-token chunk); both versions here stay finite there and are held to the
token recurrence (``models/rwkv.py::rwkv6_scan_plain``) instead.

:func:`rwkv6_chunked_plain` is the same chunked function in PyTorch.  The
wrapper routes CPU tensors to it, and ``ops.rwkv6_scan``'s backward
differentiates it (the reference's backward is the AD of its recurrence
oracle; no backward kernel exists there either).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches made by rwkv6_cuda in this process
launches = 0

PLAIN_CHUNK = 16            # keeps the (c, c, K) ratio tensor ~0.5 GB at B 8, T 512, H 32
HEAD_DIMS = (32, 64)          # rwkv6 reduced and full width

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def rwkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v (B,T,H,K); log_w (B,T,H,K) log-decay (<= 0); u (H,K).
    Returns out (B,T,H,K) in r's dtype; computes in fp32.

    Chunk-local terms for all chunks at once, then the (K, K) state carried
    over the chunks in order.  Tail rows are zero with decay 1, so they add
    nothing to the state, and their outputs are dropped."""
    b, t, h, dk = r.shape
    c = min(PLAIN_CHUNK, t)
    pad = (-t) % c
    n = (t + pad) // c

    def prep(a):                                   # (B,T,H,K) -> (B,H,n,c,K) fp32
        a = a.float().permute(0, 2, 1, 3)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.reshape(b, h, n, c, dk)

    rr, kk, vv, ld = prep(r), prep(k), prep(v), prep(log_w)
    la = torch.cumsum(ld, dim=3)                   # inclusive prefix La_t
    lp = la - ld                                   # exclusive prefix La_{t-1}
    la_end = la[:, :, :, -1:, :]                   # La_c, (B,H,n,1,K)
    # intra: P[t,s] = sum_k r_tk k_sk e^{La_{t-1,k} - La_{s,k}} for s < t
    below = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    diff = lp[:, :, :, :, None, :] - la[:, :, :, None, :, :]            # (B,H,n,c,c,K)
    ratio = torch.exp(torch.where(below[:, :, None], diff, float("-inf")))
    p = (rr[:, :, :, :, None, :] * kk[:, :, :, None, :, :] * ratio).sum(-1)
    bonus = (rr * u.float()[None, :, None, None, :] * kk).sum(-1)       # (B,H,n,c)
    p = p + torch.diag_embed(bonus)
    out = p @ vv                                                        # (B,H,n,c,K)
    # inter: (r_t e^{La_{t-1}}) S_0, with S carried over the chunks
    rq = rr * torch.exp(lp)
    ds = (kk * torch.exp(la_end - la)).transpose(-1, -2) @ vv           # (B,H,n,K,K)
    decay = torch.exp(la_end).transpose(-1, -2)                         # (B,H,n,K,1)
    s = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    inter = []
    for i in range(n):
        inter.append(rq[:, :, i] @ s)
        s = decay[:, :, i] * s + ds[:, :, i]
    out = out + torch.stack(inter, dim=2)
    out = out.reshape(b, h, n * c, dk)[:, :, :t].permute(0, 2, 1, 3)
    return out.to(r.dtype)


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`rwkv6_chunked_plain`, on a CUDA device:
    r/k/v contiguous float32 or bfloat16 of one dtype, log_w and u
    contiguous float32, head dim in ``HEAD_DIMS``."""
    global launches
    b, t, h, dk = r.shape
    dev = r.device
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, log_w, u)):
        raise ValueError("rwkv6_cuda needs r, k, v, log_w, u on one CUDA device")
    if r.dtype not in _DT or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"log_w and u must be float32, got {log_w.dtype}, {u.dtype}")
    if any(tuple(a.shape) != (b, t, h, dk) for a in (k, v, log_w)) or \
            tuple(u.shape) != (h, dk):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"log_w {tuple(log_w.shape)}, u {tuple(u.shape)} do not match")
    if dk not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes head dims {HEAD_DIMS}, got {dk}")
    if not all(a.is_contiguous() for a in (r, k, v, log_w, u)):
        raise ValueError("rwkv6_cuda needs contiguous r, k, v, log_w, u")
    out = torch.empty_like(r)
    if b == 0 or t == 0 or h == 0:
        return out
    fn = _build.function("rwkv6_scan", "rwkv6_fwd", _ARGS)
    stream = _build.stream(dev)
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                    out.data_ptr(), b, t, h, dk, _DT[r.dtype], stream), "rwkv6_fwd")
    launches += 1
    return out
