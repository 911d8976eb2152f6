"""Shared layers: norms, RoPE, MLP, embeddings (port of ``repro/models/common.py``).

Plain functions on dicts of tensors: ``init_*`` build param dicts on a given
device from an explicit ``torch.Generator``, ``apply_*`` consume them.
Layouts follow the reference: weights are ``(d_in, d_out)`` used as
``x @ W``.  Norm statistics run in fp32 regardless of compute dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def truncated_normal(shape: Sequence[int], scale: float, dtype: torch.dtype,
                     gen: torch.Generator) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2], drawn in fp32 on
    the generator's device and cast to ``dtype`` (the reference's init)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos|cos, -sin|sin) of the fp32 rotation angles, each shaped
    (..., T, 1, Dh) for positions (..., T).  Computed once per forward and
    shared by every layer (each layer of the reference recomputes them)."""
    freqs = rope_freqs(head_dim, theta, positions.device)              # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs           # (..., T, Dh/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rotate(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Split-halves rotation of x (..., T, H, Dh) in fp32, cast back:
    [x1 cos - x2 sin, x2 cos + x1 sin], bit for bit the reference's
    [x1 cos - x2 sin, x1 sin + x2 cos] (negation and swapped addends are
    exact), in fewer ops."""
    cs, sn = rope
    xf = x.float()
    return (xf * cs + xf.roll(x.shape[-1] // 2, dims=-1) * sn).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T) int."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda h: F.gelu(h, approximate="tanh"), "relu": F.relu}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, glu: bool,
             dtype: torch.dtype) -> dict:
    scale_in = d_model ** -0.5
    scale_out = d_ff ** -0.5
    p = {"wi": truncated_normal((d_model, d_ff), scale_in, dtype, gen),
         "wo": truncated_normal((d_ff, d_model), scale_out, dtype, gen)}
    if glu:
        p["wg"] = truncated_normal((d_model, d_ff), scale_in, dtype, gen)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ params["wi"]
    if "wg" in params:
        h = _ACTS[act](x @ params["wg"]) * h
    else:
        h = _ACTS[act](h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def init_embed(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> dict:
    return {"tok": truncated_normal((pad_vocab(vocab), d_model), 1.0, dtype, gen)}


def embed_tokens(params: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens, params["tok"]).to(compute_dtype)


def init_head(gen: torch.Generator, d_model: int, vocab: int, dtype: torch.dtype) -> dict:
    return {"w": truncated_normal((d_model, pad_vocab(vocab)), d_model ** -0.5, dtype, gen)}
