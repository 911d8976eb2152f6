"""Paged decode attention: the Hopper kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention_fwd``.  It is
bound by bytes (a stream over each lane's live K/V), reads each lane's block
table itself and never touches blocks past ``pos // bs``; the table's span is
cut into fixed slices, CTAs past a lane's ``pos`` exit at once, and the live
ones are merged by the last CTA of each (lane, KV head) in the same launch
(the body and the kept scratch are shared with the dense kernel,
``csrc/decode_body.cuh``).  :func:`paged_decode_attention_plain` is
the gather reference of ``repro/models/attention.py::decode_attn_paged``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_NREP, _DT,
                                                  decode_attention_plain, n_sms, scratch,
                                                  split_plan)

# kernel launches made by paged_decode_attention_cuda in this process
launches = 0

_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p)


def paged_decode_attention_plain(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                                 block_tables: torch.Tensor, pos: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q (B,1,H,D); kp/vp (NB,bs,G,D) block pool; block_tables (B,max_blocks)
    pool block ids; pos (B,) last position each lane attends.  Each lane's
    logical cache ``kp[block_tables[b]]`` is gathered whole and masked to
    ``arange(span) <= pos`` (finite -1e30, fp32 softmax).  Returns (B,1,H,D)."""
    b, _, _, d = q.shape
    bs, g = kp.shape[1], kp.shape[2]
    span = block_tables.shape[1] * bs
    idx = block_tables.long()
    ck = kp[idx].reshape(b, span, g, d)
    cv = vp[idx].reshape(b, span, g, d)
    valid = torch.arange(span, device=q.device)[None, :] <= pos[:, None]
    return decode_attention_plain(q, ck, cv, valid, scale)


def paged_decode_attention_cuda(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                                block_tables: torch.Tensor, pos: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Same contract as :func:`paged_decode_attention_plain`, on a CUDA
    device.  Table entries must lie in ``[0, NB)``: the kernel reads the
    pool block each live position names."""
    global launches
    b, one, h, d = q.shape
    nb, bs, g = kp.shape[0], kp.shape[1], kp.shape[2]
    max_blocks = block_tables.shape[1]
    dev = q.device
    if not (dev.type == "cuda" and kp.get_device() == vp.get_device()
            == block_tables.get_device() == pos.get_device() == dev.index):
        raise ValueError("paged_decode_attention_cuda needs q, kp, vp, block_tables, pos "
                         "on one CUDA device")
    dt = _DT.get(q.dtype)
    if dt is None or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"q/kp/vp must share float32 or bfloat16, got "
                        f"{q.dtype}, {kp.dtype}, {vp.dtype}")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"block_tables and pos must be int32, got {block_tables.dtype}, "
                        f"{pos.dtype}")
    if (one != 1 or kp.shape != (nb, bs, g, d) or vp.shape != kp.shape
            or block_tables.shape != (b, max_blocks) or pos.shape != (b,)):
        raise ValueError(f"shapes q {tuple(q.shape)}, kp {tuple(kp.shape)}, vp "
                         f"{tuple(vp.shape)}, block_tables {tuple(block_tables.shape)}, "
                         f"pos {tuple(pos.shape)} do not match")
    if (d not in HEAD_DIMS or h % g or h // g > MAX_NREP or max_blocks * bs == 0
            or nb * bs >= 2 ** 31):
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, at most {MAX_NREP} "
                         f"query heads per KV head, a nonempty table and a pool of under "
                         f"2^31 rows; got D={d}, H={h}, G={g}, span {max_blocks}x{bs}")
    if not (q.is_contiguous() and kp.is_contiguous() and vp.is_contiguous()
            and block_tables.is_contiguous() and pos.is_contiguous()):
        raise ValueError("paged_decode_attention_cuda needs contiguous inputs")
    k_ptr, v_ptr = kp.data_ptr(), vp.data_ptr()
    if (k_ptr | v_ptr) % 16:
        raise ValueError("paged_decode_attention_cuda needs 16-byte aligned kp/vp")
    out = torch.empty_like(q)
    if b == 0:
        return out
    _, n_split = split_plan(b, g, max_blocks * bs, n_sms(dev))
    stream = _build.stream(dev)
    part_m, part_l, part_acc, counters = scratch(dev, stream, b * g * n_split, MAX_NREP * d,
                                                 b * g)
    fn = _build.function("paged_attention", "paged_decode_attention_fwd", _ARGS)
    _build.check(fn(q.data_ptr(), k_ptr, v_ptr, block_tables.data_ptr(), pos.data_ptr(),
                    out.data_ptr(), part_m, part_l, part_acc, counters, b, bs, max_blocks, h,
                    g, d, n_split, scale, dt, stream), "paged_decode_attention_fwd")
    launches += 1
    return out
