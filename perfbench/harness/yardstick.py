"""The yardstick: peaks, operation and byte counters, the union of
intervals.  Frozen copies live here so that no later change of the program
moves them; each names the file and line it was copied from.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12            # chip_smoke.py:242
PEAK_BYTES = 3.35e12                # chip_smoke.py:244
BF16, F32 = 2, 4


def bound(flops: float, flops_peak: float, nbytes: float) -> Tuple[float, str]:
    """Least time (s) of a call and what sets it: the larger of operations
    over the peak rate and bytes over the peak bandwidth.  Copied from
    chip_smoke.py:344 (``bound``), in seconds rather than ms."""
    t_ops, t_bytes = flops / flops_peak, nbytes / PEAK_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_pairs(t: int, tk: int, causal: bool, chunk: int = 0) -> int:
    """(query, key) pairs a flash call attends: key <= query where causal,
    both in one chunk where chunked.  Copied from chip_smoke.py:538
    (``flash_pairs``); the closed form for the plain causal case."""
    if causal and not chunk and t == tk:
        return t * (t + 1) // 2
    q = np.arange(t)[:, None]
    k = np.arange(tk)[None, :]
    seen = np.ones((t, tk), bool)
    if causal:
        seen &= k <= q
    if chunk:
        seen &= q // chunk == k // chunk
    return int(seen.sum())


def flash_call(b: int, t: int, h: int, g: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal flash call over (B, T) with H query and
    G key/value heads of width D in bf16: QK^T and PV over the attended
    pairs (2 operations a multiply-add, so 4 H D a pair), q, k and v read
    once and the output written once.  The counting of chip_smoke.py:583."""
    flops = 4.0 * b * h * d * flash_pairs(t, t, True)
    nbytes = float(b * t * (2 * h + 2 * g) * d * BF16)
    return flops, nbytes


def decode_call(lanes: int, live: int, h: int, g: int, d: int,
                span: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of one dense-lane decode-attention call: ``live``
    positions attended over all lanes, each read once as K and V for the G
    heads, the (lanes, H, D) query read and output written, and the
    (lanes, span) validity mask read.  The counting of chip_smoke.py:505,
    with the live positions of the step."""
    flops = 4.0 * h * d * live
    nbytes = float(live * 2 * g * d * BF16 + 2 * lanes * h * d * BF16 + lanes * span)
    return flops, nbytes


def rwkv6_flops(b: int, t: int, h: int, dk: int, c: int = 16) -> float:
    """Operations of the chunked WKV6 recurrence at chunk ``c``.  Copied
    from chip_smoke.py:1009 (``rwkv6_flops``): per chunk and (batch, head)
    the inter term (2cK^2), the scores of the c(c-1)/2 pairs (3K each) and
    the bonus diagonal (3cK), P v over the c(c+1)/2 pairs (2K each), the
    decay weights (2cK) and the state update (2cK^2 + K^2)."""
    per_chunk = (4 * c * dk * dk + dk * dk + 3 * c * (c - 1) // 2 * dk + 3 * c * dk
                 + c * (c + 1) * dk + 2 * c * dk)
    return float(b * h * -(-t // c) * per_chunk)


def rwkv6_call(b: int, t: int, h: int, dk: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward WKV6 call in bf16: r, k, v read and the
    output written in bf16, the fp32 log-decay read, u read.  The byte count
    of chip_smoke.py:1025 (``RWKV_BYTES``) at any shape."""
    n = b * t * h * dk
    return rwkv6_flops(b, t, h, dk), float(4 * n * BF16 + n * F32 + h * dk * F32)


def merged_length(intervals: List[Tuple[int, int]]) -> int:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def sync() -> None:
    """Wait for the device, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
