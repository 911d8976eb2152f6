"""Decode attention: the Hopper kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_fwd``.  It is bound by
bytes (a stream over the live K/V): one CTA per (KV head, lane, slice), the
span cut into slices while the (lane, KV head) pairs are fewer than the SMs
(flash-decoding), and the slices merged by the last CTA of each
(lane, KV head) in the same launch (the body is shared with the paged
kernel, ``csrc/decode_body.cuh``).  The merge's fp32 scratch and its
counters, which the kernel leaves at 0, are kept per device and stream and
grown when a call needs more, so a call allocates only its output and
launches one kernel.  :func:`decode_attention_plain` ports
``repro/kernels/ref.py::decode_attention_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches made by decode_attention_cuda in this process
launches = 0

NEG_INF = -1e30
TILE = 64                   # slices are whole tiles of this many positions (csrc DEC_TILE)
MAX_NREP = 8                # query heads per KV head (csrc MAX_NREP)
HEAD_DIMS = (32, 64, 112, 128)
MAX_SPLIT = 4096            # positions a slice holds at most (csrc DEC_MAX_SPLIT)

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
    """(split_len, n_split): a CTA's ring takes most of an SM's shared memory,
    so one CTA an SM: where the B*G (lane, KV head) pairs are fewer than the
    SMs, the span is cut into n_sms // (B*G) tile-aligned slices, else not
    at all; never more slices than tiles and none longer than MAX_SPLIT.  The
    paged kernel takes the same cut of its table's span."""
    tiles = -(-s // TILE)
    n_split = min(tiles, max(1, n_sms // (b * g), -(-tiles * TILE // MAX_SPLIT)))
    split_len = -(-tiles // n_split) * TILE
    return split_len, -(-s // split_len)


class Scratch(NamedTuple):
    """The merge's scratch on one device and stream: its capacity, the raw
    pointers (part_m, part_l, part_acc, counters) and the tensors behind
    them ((part_m; part_l), part_acc, counters)."""
    slots: int
    slot_floats: int
    pairs: int
    ptrs: Tuple[int, int, int, int]
    tensors: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


_SMS: Dict[int, int] = {}
_SCRATCH: Dict[Tuple[int, int], Scratch] = {}


def n_sms(dev: torch.device) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def scratch(dev: torch.device, stream: int, slots: int, slot_floats: int,
            pairs: int) -> Tuple[int, int, int, int]:
    """Pointers to the merge's scratch on ``dev`` for kernels on ``stream``:
    part_m and part_l (``slots`` x MAX_NREP fp32), part_acc (``slots`` x
    ``slot_floats``) and ``pairs`` int32 counters, zeroed when made; the
    kernels leave every counter at 0.  Kept per (device, stream), since two
    streams' launches may overlap, and grown when a call needs more."""
    held = _SCRATCH.get((dev.index, stream))
    if held is not None:
        if held.slots >= slots and held.slot_floats >= slot_floats and held.pairs >= pairs:
            return held.ptrs
        slots, slot_floats = max(slots, held.slots), max(slot_floats, held.slot_floats)
        pairs = max(pairs, held.pairs)
    ml = torch.empty((2, slots * MAX_NREP), dtype=torch.float32, device=dev)
    acc = torch.empty((slots * slot_floats,), dtype=torch.float32, device=dev)
    cnt = torch.zeros((pairs,), dtype=torch.int32, device=dev)
    ptrs = (ml[0].data_ptr(), ml[1].data_ptr(), acc.data_ptr(), cnt.data_ptr())
    _SCRATCH[(dev.index, stream)] = Scratch(slots, slot_floats, pairs, ptrs, (ml, acc, cnt))
    return ptrs


def decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Same contract as :func:`decode_attention_plain`, on a CUDA device.
    A lane whose ``valid`` row is all False returns the mean of V over the
    span, as the TPU kernel's finite mask gives (uniform softmax)."""
    global launches
    b, one, h, d = q.shape
    s, g = ck.shape[1], ck.shape[2]
    dev = q.device
    if not (dev.type == "cuda" and ck.get_device() == cv.get_device() == valid.get_device()
            == dev.index):
        raise ValueError("decode_attention_cuda needs q, ck, cv, valid on one CUDA device")
    dt = _DT.get(q.dtype)
    if dt is None or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"q/ck/cv must share float32 or bfloat16, got "
                        f"{q.dtype}, {ck.dtype}, {cv.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if one != 1 or ck.shape != (b, s, g, d) or cv.shape != ck.shape or valid.shape != (b, s):
        raise ValueError(f"shapes q {tuple(q.shape)}, ck {tuple(ck.shape)}, "
                         f"cv {tuple(cv.shape)}, valid {tuple(valid.shape)} do not match")
    if d not in HEAD_DIMS or h % g or h // g > MAX_NREP or b * s >= 2 ** 31:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, at most {MAX_NREP} "
                         f"query heads per KV head and B*S < 2^31; got D={d}, H={h}, G={g}")
    if not (q.is_contiguous() and ck.is_contiguous() and cv.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous inputs")
    k_ptr, v_ptr = ck.data_ptr(), cv.data_ptr()
    if (k_ptr | v_ptr) % 16:
        raise ValueError("decode_attention_cuda needs 16-byte aligned ck/cv")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    split_len, n_split = split_plan(b, g, s, n_sms(dev))
    stream = _build.stream(dev)
    part_m, part_l, part_acc, counters = scratch(dev, stream, b * g * n_split, MAX_NREP * d,
                                                 b * g)
    fn = _build.function("decode_attention", "decode_attention_fwd", _ARGS)
    _build.check(fn(q.data_ptr(), k_ptr, v_ptr, valid.data_ptr(), out.data_ptr(), part_m,
                    part_l, part_acc, counters, b, s, h, g, d, split_len, n_split, scale, dt,
                    stream), "decode_attention_fwd")
    launches += 1
    return out
