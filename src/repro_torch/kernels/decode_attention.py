"""Decode attention: the Hopper kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_fwd``.  It is bound by
bytes (a stream over the live K/V), and at serving batch one CTA per
(lane, KV head) would leave half the SMs idle, so the span is split
(flash-decoding) and the slices are merged by the last CTA of each
(lane, KV head) in the same launch.  :func:`decode_attention_plain` ports
``repro/kernels/ref.py::decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# kernel launches made by decode_attention_cuda in this process
launches = 0

NEG_INF = -1e30
TILE = 64                   # positions per tile (csrc DEC_TILE)
MAX_NREP = 8                # query heads per KV head (csrc MAX_NREP)
HEAD_DIMS = (32, 64, 128)

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int,
                                                        ctypes.c_void_p)


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,1,H,D); ck/cv (B,S,G,D); valid (B,S) bool.  Returns (B,1,H,D)."""
    b, _, h, d = q.shape
    s, g = ck.shape[1], ck.shape[2]
    nrep = h // g
    kk = ck[:, :, :, None, :].expand(b, s, g, nrep, d).reshape(b, s, h, d)
    vv = cv[:, :, :, None, :].expand(b, s, g, nrep, d).reshape(b, s, h, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device))
    p = torch.softmax(logits, dim=-1).to(vv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def split_plan(b: int, g: int, s: int, n_sms: int) -> Tuple[int, int]:
    """(split_len, n_split): cut the span into tile-aligned slices so that
    B*G*n_split CTAs give every SM about two, never more slices than tiles."""
    tiles = -(-s // TILE)
    n_split = min(tiles, max(1, -(-2 * n_sms // (b * g))))
    split_len = -(-tiles // n_split) * TILE
    return split_len, -(-s // split_len)


def decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Same contract as :func:`decode_attention_plain`, on a CUDA device.
    A lane whose ``valid`` row is all False returns zeros."""
    global launches
    b, one, h, d = q.shape
    s, g = ck.shape[1], ck.shape[2]
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (ck, cv, valid)):
        raise ValueError("decode_attention_cuda needs q, ck, cv, valid on one CUDA device")
    if q.dtype not in _DT or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"q/ck/cv must share float32 or bfloat16, got "
                        f"{q.dtype}, {ck.dtype}, {cv.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if (one != 1 or tuple(ck.shape) != (b, s, g, d) or tuple(cv.shape) != (b, s, g, d)
            or tuple(valid.shape) != (b, s)):
        raise ValueError(f"shapes q {tuple(q.shape)}, ck {tuple(ck.shape)}, "
                         f"cv {tuple(cv.shape)}, valid {tuple(valid.shape)} do not match")
    if d not in HEAD_DIMS or h % g or h // g > MAX_NREP:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS} and at most "
                         f"{MAX_NREP} query heads per KV head; got D={d}, H={h}, G={g}")
    if not all(t.is_contiguous() for t in (q, ck, cv, valid)):
        raise ValueError("decode_attention_cuda needs contiguous inputs")
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("decode_attention_cuda needs 16-byte aligned ck/cv")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    nrep = h // g
    split_len, n_split = split_plan(
        b, g, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_m = torch.empty((b, g, n_split, nrep), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, g, n_split, nrep, d), dtype=torch.float32, device=dev)
    counters = torch.zeros((b * g,), dtype=torch.int32, device=dev)
    fn = _build.function("decode_attention", "decode_attention_fwd", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                    part_acc.data_ptr(), counters.data_ptr(), b, s, h, g, d, split_len,
                    n_split, scale, _DT[q.dtype], stream), "decode_attention_fwd")
    launches += 1
    return out
