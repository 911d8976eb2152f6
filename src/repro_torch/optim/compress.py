"""int8 gradient compression with error feedback (port of
``repro/optim/compress.py``), on tensors of any device.

Scheme: per-leaf absmax scaling to int8; the quantisation residual is FED
BACK into the next step's gradient (error feedback — Karimireddy et al.
2019 — restores convergence of biased compressors).  The federated plane
(:mod:`repro_torch.optim.fed`) frames its update deltas through it.

The arithmetic is the reference's, operation for operation, in fp32:
``torch.round`` rounds half to even as ``jnp.round`` does, and the top-k
mask keeps every entry whose magnitude is ``>=`` the k-th largest, so the
order in which ties are broken cannot change which entries survive.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.convert import leaves, tree_map, unflatten


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 scale).  scale = absmax/127 (0-safe).

    Non-finite entries (NaN / ±inf — a diverged or overflowed step) are
    treated as zero: one bad entry must not blow the absmax scale to inf
    (which would quantise every OTHER entry to 0 and poison the error-
    feedback residual with NaN forever after)."""
    g32 = g.to(torch.float32)
    g32 = torch.where(torch.isfinite(g32), g32, 0.0)
    scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _kth_largest(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest entry of a 1-D tensor (``jax.lax.top_k(flat, k)[0][-1]``)."""
    return torch.topk(flat, k, sorted=True).values[-1]


def compress_tree(grads: Any, error: Any,
                  topk_frac: Optional[float] = None) -> Tuple[Any, Any, Any]:
    """Quantise (grads + error-feedback); returns (q_tree, scale_tree,
    new_error_tree).  new_error = (g + e) - deq(q).

    With ``topk_frac`` in (0, 1], only the top-k largest-magnitude entries
    per leaf survive quantisation; the rest are zeroed BEFORE the residual
    is taken, so error feedback carries the dropped mass into the next
    round (sparsified SGD with memory — Stich et al. 2018).

    The residual is computed from the SANITISED corrected gradient (non-
    finite entries zeroed, matching :func:`quantize`): error feedback must
    carry quantisation error forward, never NaN/inf."""
    if topk_frac is not None and not 0.0 < topk_frac <= 1.0:
        raise ValueError(f"topk_frac must be in (0, 1], got {topk_frac}")

    def one(g, e):
        corrected = g.to(torch.float32) + e
        corrected = torch.where(torch.isfinite(corrected), corrected, 0.0)
        kept = corrected
        if topk_frac is not None and topk_frac < 1.0:
            flat = torch.abs(corrected).reshape(-1)
            k = max(1, int(round(topk_frac * flat.numel())))
            thr = _kth_largest(flat, k)
            kept = torch.where(torch.abs(corrected) >= thr, corrected, 0.0)
        q, s = quantize(kept)
        new_e = corrected - dequantize(q, s)
        return q, s, new_e

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(qs: Any, ss: Any, dtype=torch.float32) -> Any:
    return unflatten(qs, [dequantize(q, s, dtype) for q, s in zip(leaves(qs), leaves(ss))])


def init_error(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)


def wire_bytes_saved(grads: Any) -> Tuple[int, int]:
    """(bf16 bytes, int8+scale bytes) for the synced tree."""
    flat = list(leaves(grads))
    n = sum(g.numel() for g in flat)
    return 2 * n, n + 4 * len(flat)
