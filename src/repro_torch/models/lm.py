"""Decoder-only LM assembly, dense family (port of ``repro/models/lm.py``).

Params::

    {"embed": {"tok": (Vp, D)},
     "blocks": [one dict per layer],          # the reference stacks (L, ...)
     "final_ln": {"scale": (D,)},
     "head": {"w": (D, Vp)}}                  # absent when tied

Cache (decode)::

    {"layers": {"k": (L, B, span, KVH, Dh), "v": ...}, "pos": (B,) int32}

Decode writes each step's K/V into ``cache["layers"]`` IN PLACE (the
reference donates the buffers to jit instead) and returns a cache dict with
the advanced ``pos``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import cache_span, decode_slots, init_kv_cache
from repro_torch.models.common import (embed_tokens, init_embed, init_head, init_rmsnorm,
                                       rmsnorm, rope_tables)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_lm(cfg: ModelConfig, gen: torch.Generator, param_dtype: torch.dtype) -> dict:
    """Random weights drawn in a fixed order from ``gen`` on its device."""
    p = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, param_dtype),
         "blocks": [B.init_block(gen, cfg, param_dtype) for _ in range(cfg.n_layers)],
         "final_ln": init_rmsnorm(cfg.d_model, param_dtype, gen.device)}
    if not cfg.tie_embeddings:
        p["head"] = init_head(gen, cfg.d_model, cfg.vocab_size, param_dtype)
    return p


def head_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits (..., Vp) of final hidden states ``h``: the reference's
    ``h @ head_weight``.  Tied embeddings are rescaled by d_model**-0.5 to
    keep logits O(1); the scale goes on ``h``, not on a (D, Vp) copy of the
    table (bit-exact where d_model is a power of 4, as for granite-8b)."""
    if cfg.tie_embeddings:
        return (h * cfg.d_model ** -0.5) @ params["embed"]["tok"].t().to(h.dtype)
    return h @ params["head"]["w"].to(h.dtype)


def _prefill_trunk(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                   rcfg: RunConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """Prompt forward: (hidden (B,T,D) after the final norm, stacked K/V)."""
    cdt = dtype_of(rcfg.compute_dtype)
    tokens = batch["tokens"]
    bsz, t = tokens.shape
    x = embed_tokens(params["embed"], tokens, cdt)
    span = cache_span(cfg, max_len)
    rope = rope_tables(torch.arange(t, device=tokens.device)[None, :], cfg.head_dim,
                       cfg.rope_theta)
    layers = init_kv_cache(cfg, bsz, max_len, cdt, tokens.device)
    for i, bp in enumerate(params["blocks"]):
        x, cl = B.block_prefill(cfg, bp, x, rope, span)
        layers["k"][i].copy_(cl["k"])
        layers["v"][i].copy_(cl["v"])
    return rmsnorm(params["final_ln"], x), layers


def lm_prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
               rcfg: RunConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """Process a prompt; return (last-token logits (B, Vp), cache)."""
    x, layers = _prefill_trunk(cfg, params, batch, rcfg, max_len)
    bsz, t = x.shape[:2]
    logits = head_logits(cfg, params, x[:, -1])
    pos = torch.full((bsz,), t, dtype=torch.int32, device=x.device)
    return logits, {"layers": layers, "pos": pos}


def lm_prefill_padded(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                      lengths: torch.Tensor, rcfg: RunConfig,
                      max_len: int) -> Tuple[torch.Tensor, dict]:
    """Batched prefill of right-padded prompts with true ``lengths`` (B,).

    Exact for full causal attention: pad tokens sit strictly after every real
    token, so causality keeps them out of all real hidden states, the logits
    are gathered at each lane's last real position, and the per-lane cache
    ``pos`` masks the pad garbage out of decode until the step that
    overwrites it."""
    x, layers = _prefill_trunk(cfg, params, batch, rcfg, max_len)
    lengths = lengths.to(torch.int32)
    h = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]
    logits = head_logits(cfg, params, h)
    return logits, {"layers": layers, "pos": lengths}


def lm_decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                   rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) int.  Returns (logits (B,Vp), cache);
    the K/V of ``cache["layers"]`` are updated in place."""
    cdt = dtype_of(rcfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, cdt)
    pos = cache["pos"]
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    rows, valid = decode_slots(cfg, pos, ks.shape[2])
    for i, bp in enumerate(params["blocks"]):
        x = B.block_decode(cfg, bp, x, ks[i], vs[i], rope, rows, valid)
    x = rmsnorm(params["final_ln"], x)
    logits = head_logits(cfg, params, x[:, -1])
    return logits, {"layers": cache["layers"], "pos": pos + 1}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
               device) -> dict:
    B.require_dense(cfg)
    return {"layers": init_kv_cache(cfg, batch, max_len, dtype, device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
