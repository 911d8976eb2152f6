"""Mamba2 SSD chunk scan: the Hopper kernel's wrapper and its plain version.

The kernel (``csrc/mamba2_ssd.cu``) replaces the TPU kernel
``repro/kernels/mamba2_ssd.py::mamba2_ssd_fwd``.  bf16 inputs take its
tensor-core body: a CTA walks the chunks for two heads of a batch, C.B^T
formed once per (batch, chunk) for both, every chunk product on mma.sync
with the fp32 operands split into hi + lo bf16 terms, each warp's rows of
the fp32 state in registers.  fp32 inputs (the parity runs) take a scalar
body, one CTA per (batch, head).  Both read x and B/C through their
strides, so the views the model cuts out of the conv output go in without
a copy.

Per head, over chunks of ``CHUNK`` tokens with ``la`` the inclusive prefix
sum of ``dt * A`` (<= 0) within the chunk and ``S0`` the state before it:

    y_t = e^{la_t} C_t . S0^T + sum_{s<=t} e^{la_t - la_s} (C_t . B_s) dt_s x_s + D x_t
    S   = e^{la_c} S0 + sum_s e^{la_c - la_s} dt_s x_s (x) B_s

Only pairs with s <= t are formed, so every exponent is <= 0.  The plain
version masks the pairs s > t to -inf BEFORE the exponential: a masked
``exp`` of their positive exponent overflows once a chunk's log-decay
passes ~88, and autograd through ``where(mask, exp(d), 0)`` then gives
NaN gradients (a zero cotangent times inf).  Both versions also keep the
digits of ``la_t - la_s`` when the two prefix sums are large (strong decay):
the plain version sums each pair's segment ``sum_{s<r<=t} dt_r A`` on its
own, the kernel keeps its prefix sums in fp64.

:func:`mamba2_ssd_chunked_plain` is the same chunked function in PyTorch.
The wrapper routes CPU tensors to it, and ``ops.mamba2_ssd``'s backward
differentiates it (the reference's backward is the AD of its recurrence
oracle; no backward kernel exists there either).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# kernel launches made by mamba2_ssd_cuda in this process
launches = 0

CHUNK = 64                    # the kernel's chunk, the reference's DEFAULT_CHUNK
SHAPES = ((32, 16), (64, 64))   # (P, N): zamba2 reduced and full width

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_longlong,) * 6 + (ctypes.c_int,) * 6
         + (ctypes.c_void_p,))


def mamba2_ssd_chunked_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                             chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); dt (B,T,H) fp32; A (H,) <= 0; B/C (B,T,N) shared by the
    heads; D (H,).  Returns (y (B,T,H,P) in x's dtype, final state
    (B,H,P,N) fp32); computes in fp32.

    Chunk-local terms for all chunks at once as batched products, then the
    state carried over the chunks in order.  Tail rows are zero with dt = 0
    (decay 1, no update), and their outputs are dropped."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    nc = (t + pad) // c

    def prep(a):                          # (B,T,...) -> (B,nc,c,...) fp32, tail zeros
        a = a.float()
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(b, nc, c, *a.shape[2:])

    xc, dtc, bc, cc = prep(x), prep(dt), prep(B), prep(C)   # (b,nc,c,h,p) (b,nc,c,h) (b,nc,c,n)
    da = dtc * A.float()                                    # (b,nc,c,h) log-decay per step
    la = torch.cumsum(da, dim=2)                            # inclusive prefix within the chunk
    # segment sums seg[t, s] = sum_{s < r <= t} da_r, each column summed from
    # its own start: the difference la_t - la_s of two long prefix sums would
    # lose the digits that matter for the pairs that count (and their dA)
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    rep = da.transpose(2, 3)[..., None].expand(b, nc, h, c, c)       # rep[.., r, s] = da_r
    seg = torch.cumsum(rep.masked_fill(~causal.tril(-1), 0.0), dim=3)  # (b,nc,h,t,s)
    # intra: G[t,s] = e^{seg[t,s]} (C_t . B_s) dt_s for s <= t; the mask goes
    # on the exponent, so no exp of a positive number is ever formed
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    g = (cc @ bc.transpose(-1, -2))[:, :, None] * decay * dtc.transpose(2, 3)[:, :, :, None]
    y = torch.einsum("bzhts,bzshp->bzthp", g, xc)
    # each chunk's own state increment, e^{la_c - la_s} = e^{seg[c-1, s]}
    w = torch.exp(seg[:, :, :, -1]).transpose(2, 3) * dtc    # (b,nc,c,h)
    ds = torch.einsum("bzshp,bzsn->bzhpn", w[..., None] * xc, bc)
    la_end = la[:, :, -1]                                   # (b,nc,h)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    inter = []
    for i in range(nc):
        inter.append(torch.einsum("bhpn,btn->bthp", s, cc[:, i])
                     * torch.exp(la[:, i])[..., None])
        s = torch.exp(la_end[:, i])[:, :, None, None] * s + ds[:, i]
    y = y + torch.stack(inter, dim=1) + D.float()[:, None] * xc
    y = y.reshape(b, nc * c, h, p)[:, :t]
    return y.to(x.dtype), s


def mamba2_ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`mamba2_ssd_chunked_plain`, on a CUDA device.

    x (B,T,H,P) and B/C (B,T,N) float32 or bfloat16 of one dtype, each with
    its (H, P) resp. N dims packed (any batch and token strides: the model
    passes views of its conv output); dt (B,T,H), A and D (H,) contiguous
    float32; (P, N) in ``SHAPES``."""
    global launches
    b, t, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if dev.type != "cuda" or any(a.device != dev for a in (dt, A, B, C, D)):
        raise ValueError("mamba2_ssd_cuda needs x, dt, A, B, C, D on one CUDA device")
    if x.dtype not in _DT or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x/B/C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if any(a.dtype != torch.float32 for a in (dt, A, D)):
        raise TypeError(f"dt, A and D must be float32, got {dt.dtype}, {A.dtype}, {D.dtype}")
    if (tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,) or tuple(D.shape) != (h,)
            or tuple(B.shape) != (b, t, n) or tuple(C.shape) != (b, t, n)):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)} "
                         f"do not match")
    if (p, n) not in SHAPES:
        raise ValueError(f"mamba2 SSD kernel takes (P, N) in {SHAPES}, got ({p}, {n})")
    if x.stride(3) != 1 or x.stride(2) != p or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("mamba2_ssd_cuda needs x's (H, P) and B/C's N dims packed")
    if not all(a.is_contiguous() for a in (dt, A, D)):
        raise ValueError("mamba2_ssd_cuda needs contiguous dt, A, D")
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return y, state
    if t == 0:
        return y, state.zero_()
    fn = _build.function("mamba2_ssd", "mamba2_ssd_fwd", _ARGS)
    stream = _build.stream(dev)
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    D.data_ptr(), y.data_ptr(), state.data_ptr(),
                    x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0),
                    C.stride(1), b, t, h, p, n, _DT[x.dtype], stream), "mamba2_ssd_fwd")
    launches += 1
    return y, state
