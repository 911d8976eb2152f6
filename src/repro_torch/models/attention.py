"""GQA self-attention with a dense KV cache (port of ``repro/models/attention.py``).

Prefill attention always goes through ``ops.flash_attention`` and decode
attention through ``ops.decode_attention``: on CUDA tensors they launch the
Hopper kernels, on CPU tensors they run the kernels' plain versions.  The
reference's ``RunConfig.use_kernels`` switch has no effect here (the device
decides), so nothing on the card can reach a plain version.  Layouts: q
``(B,T,H,D)``, k/v ``(B,T,G,D)``, caches ``(B,span,G,D)`` per layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rotate, truncated_normal

Rope = Tuple[torch.Tensor, torch.Tensor]          # from common.rope_tables


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = d ** -0.5
    p = {"wq": truncated_normal((d, qd), s, dtype, gen),
         "wk": truncated_normal((d, kvd), s, dtype, gen),
         "wv": truncated_normal((d, kvd), s, dtype, gen),
         "wo": truncated_normal((qd, d), qd ** -0.5, dtype, gen)}
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _proj_qkv(params: dict, x: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    q = x @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    b, t = x.shape[:2]
    tk = xkv.shape[1]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, tk, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, tk, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _self_attend(q, k, v, cfg: ModelConfig, causal: bool):
    """Attention core of :func:`attention` / :func:`prefill_attn`."""
    local_chunk = cfg.chunk_size if cfg.attention == "chunked_local" else 0
    return ops.flash_attention(q, k, v, causal=causal, scale=cfg.head_dim ** -0.5,
                               chunk=local_chunk)


def attention(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (no cache)."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _proj_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _self_attend(q, k, v, cfg, causal)
    return out.reshape(b, t, cfg.q_dim) @ params["wo"]


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def cache_span(cfg: ModelConfig, max_len: int) -> int:
    """chunked_local archs only need the last ``chunk_size`` positions."""
    return max_len if cfg.attention != "chunked_local" else min(max_len, cfg.chunk_size)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                  device) -> dict:
    """Zeroed K/V for every layer: (L, B, span, KVH, Dh) each."""
    shape = (cfg.n_layers, batch, cache_span(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_slots(cfg: ModelConfig, pos: torch.Tensor,
                 span: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where this step's K/V go and which cache slots it attends, shared by
    every layer of a decode step: (row of each lane's write slot in the
    (B*span, ...) flattened cache, valid (B, span)).

    The write slot is ``min(pos, span-1)`` (``pos % span`` for
    chunked_local's ring buffer, a sliding-window approximation of chunked
    attention at decode time); ``valid`` marks every written slot."""
    b = pos.shape[0]
    if cfg.attention == "chunked_local":
        slot = pos % span
    else:
        slot = torch.clamp(pos, max=span - 1)
    rows = torch.arange(b, device=pos.device) * span + slot.long()
    valid = torch.arange(span, device=pos.device)[None, :] <= torch.clamp(
        pos, max=span - 1)[:, None]
    return rows, valid


def decode_attn(params: dict, cfg: ModelConfig, x: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, rope: Rope, rows: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """One-token decode for one layer.

    x: (B,1,D); ck/cv: (B,span,KVH,Dh); ``rope`` the tables of the lanes'
    positions, ``rows`` / ``valid`` from :func:`decode_slots`.
    Writes this token's K/V into ``ck``/``cv`` IN PLACE (where the
    reference returns updated caches), then attends over every written
    slot.  Returns the attention output (B,1,D).
    """
    b = x.shape[0]
    q, k, v = _proj_qkv(params, x, x, cfg)
    q, k = rotate(q, rope), rotate(k, rope)
    span = ck.shape[1]
    ck.view(b * span, *ck.shape[2:]).index_copy_(0, rows, k[:, 0].to(ck.dtype))
    cv.view(b * span, *cv.shape[2:]).index_copy_(0, rows, v[:, 0].to(cv.dtype))
    out = ops.decode_attention(q, ck.to(q.dtype), cv.to(q.dtype), valid, cfg.head_dim ** -0.5)
    return out.reshape(b, 1, cfg.q_dim) @ params["wo"]


def prefill_attn(params: dict, cfg: ModelConfig, x: torch.Tensor, rope: Rope,
                 span: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full self-attention AND the K/V cache content for one layer; ``rope``
    holds the (cos, sin) tables of positions 0..T-1.

    Returns (out (B,T,D), ck (B,span,KVH,Dh), cv)."""
    b, t, _ = x.shape
    q, k, v = _proj_qkv(params, x, x, cfg)
    q, k = rotate(q, rope), rotate(k, rope)
    out = _self_attend(q, k, v, cfg, True)
    out = out.reshape(b, t, cfg.q_dim) @ params["wo"]
    if t >= span:                                     # chunked_local: keep tail
        ck, cv = k[:, t - span:], v[:, t - span:]
    else:
        pad = torch.zeros((b, span - t) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
        ck, cv = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    return out, ck, cv
