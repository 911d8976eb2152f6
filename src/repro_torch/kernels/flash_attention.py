"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``; at prefill widths
it is bound by operations, so each CTA holds one 64-row query tile and
streams K/V tiles past it, skipping tiles no row of it can see; bf16 runs
on the tensor cores (``mma.sync``), fp32 on scalar FMA.
:func:`flash_attention_plain` ports the blockwise oracle
``repro/models/flash_ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# kernel launches made by flash_attention_cuda in this process
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_int,
                                                        ctypes.c_void_p)


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
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, tk, h,
                    g, d, int(causal), int(chunk), scale, _DT[q.dtype], stream),
                 "flash_attention_fwd")
    launches += 1
    return out
