"""Public entry points of the port's kernels.

Routing: a tensor on the CPU goes to the kernel's plain PyTorch version; a
tensor on a CUDA device launches the hand-written kernel, which raises on
what it does not take.  There is no fallback between the two.

Each kernel module keeps a plain-integer count of its launches
(``<module>.launches``); :func:`launch_counts` reads them all, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rmsnorm as _rms

_COUNTED = {"flash_attention": _fa, "decode_attention": _dec,
            "paged_decode_attention": _paged, "rmsnorm": _rms}


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    chunk: int = 0) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,Tk,G,D) -> (B,T,H,D)."""
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale, chunk=chunk)
    return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale, chunk=chunk)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,1,H,D), ck/cv (B,S,G,D), valid (B,S) bool -> (B,1,H,D)."""
    if _on_cpu(q):
        return _dec.decode_attention_plain(q, ck, cv, valid, scale)
    return _dec.decode_attention_cuda(q, ck, cv, valid, scale)


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """q (B,1,H,D), kp/vp (NB,bs,G,D) block pool, block_tables (B,max_blocks)
    int32, pos (B,) int32 last attended position -> (B,1,H,D)."""
    if _on_cpu(q):
        return _paged.paged_decode_attention_plain(q, kp, vp, block_tables, pos, scale)
    return _paged.paged_decode_attention_cuda(q, kp, vp, block_tables, pos, scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _on_cpu(x):
        return _rms.rmsnorm_plain(x, scale, eps)
    return _rms.rmsnorm_cuda(x, scale, eps)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
