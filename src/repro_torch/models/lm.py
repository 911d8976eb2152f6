"""Decoder-only LM assembly: dense, MoE, pure-SSM, rwkv, hybrid and the vlm's
LM backbone (port of ``repro/models/lm.py``).

Params::

    {"embed": {"tok": (Vp, D)},
     "blocks": [one dict per layer],          # the reference stacks (L, ...)
     "shared": <zamba2 shared attn block>     # hybrid only
     "final_ln": {"scale": (D,)},
     "head": {"w": (D, Vp)}}                  # absent when tied

Cache (decode), the reference's tree: dense lanes or a block pool, or the
recurrent state of rwkv and zamba2::

    {"layers": {"k": (L, B, span, KVH, Dh), "v": ...}, "pos": (B,) int32}
    {"layers": {"k": (L, NB + 1, bs, KVH, Dh), "v": ...}, "pos": (B,) int32}
    {"layers": {"S": (L, B, H, K, K) fp32, "last": (L, B, D), "last_c": (L, B, D)},
     "pos": (B,) int32}                                                   # rwkv
    {"layers": {"conv": (L, B, K-1, C), "ssm": (L, B, H, P, N) fp32},
     "ak": (n_attn, B, span, KVH, Dh), "av": ..., "pos": (B,) int32}     # hybrid

Leaves not marked fp32 are in the compute dtype.  Every family trains
(:func:`lm_loss`) and serves (prefill, decode, caches); the batched padded
prefill and the block pool are wired by ``models/api.py``'s gates.

A frontend batch (internvl2's stubbed vision rows) carries ``"frontend"``
(B, P, D): the first P positions are those rows, the rest the tokens'
embeddings, so the cache's positions count the rows too.

Decode writes each step's K/V, or each layer's new recurrent state, into
the cache IN PLACE (the reference donates the buffers to jit instead) and
returns a cache dict with the advanced ``pos``.

The dense family also runs as a layer-split model: :func:`lm_stage_prefill`
and :func:`lm_stage_decode_step` run one stage's layer range; the full
model's :func:`lm_prefill` and dense :func:`lm_decode_step` are their
one-stage case, so a cut changes nothing but where the layer loop pauses.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import blocks as B
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import cache_span, decode_slots, init_kv_cache, paged_slots
from repro_torch.models.common import (chunked_xent, embed_tokens, init_embed, init_head,
                                       init_rmsnorm, rmsnorm, rope_tables)


AUX_COEF = 0.01


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_lm(cfg: ModelConfig, gen: torch.Generator, param_dtype: torch.dtype) -> dict:
    """Random weights drawn in a fixed order from ``gen`` on its device."""
    p = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, param_dtype),
         "blocks": [B.init_block(gen, cfg, param_dtype) for _ in range(cfg.n_layers)],
         "final_ln": init_rmsnorm(cfg.d_model, param_dtype, gen.device)}
    shared = B.init_shared(gen, cfg, param_dtype)
    if shared is not None:
        p["shared"] = shared
    if not cfg.tie_embeddings:
        p["head"] = init_head(gen, cfg.d_model, cfg.vocab_size, param_dtype)
    return p


def head_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits (..., Vp) of final hidden states ``h``: the reference's
    ``h @ head_weight``.  Tied embeddings are rescaled by d_model**-0.5 to
    keep logits O(1); the scale goes on ``h``, not on a (D, Vp) copy of the
    table (bit-exact where d_model is a power of 4, as for granite-8b; one
    rounding apart elsewhere, as for zamba2-7b's 3584)."""
    if cfg.tie_embeddings:
        return (h * cfg.d_model ** -0.5) @ params["embed"]["tok"].t().to(h.dtype)
    return h @ params["head"]["w"].to(h.dtype)


def _layer_train(cfg: ModelConfig, bp: dict, shared, x: torch.Tensor,
                 idx: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``idx``, then zamba2's shared block where it fires after it:
    (x, the layer's MoE balance loss or None)."""
    x, aux = B.block_train(cfg, bp, x)
    if shared is not None:
        x = B.shared_attn_train(cfg, shared, x, idx)
    return x, aux


def layers_train(cfg: ModelConfig, blocks: list, shared, x: torch.Tensor, rcfg: RunConfig,
                 start: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``blocks`` (layers ``start``, ``start + 1``, ...) over the full
    sequence; zamba2's shared block fires by the global layer index.
    Returns (x, the MoE balance losses summed over the layers, or None where
    no layer has one).  With ``rcfg.remat`` (and grad on) each layer -- with
    the shared block that fires after it -- is checkpointed, its activations
    recomputed in the backward (the reference's ``jax.checkpoint`` of the
    scan body)."""
    remat = rcfg.remat and torch.is_grad_enabled()
    total = None
    for idx, bp in enumerate(blocks, start):
        if remat:
            x, aux = checkpoint(_layer_train, cfg, bp, shared, x, idx, use_reentrant=False)
        else:
            x, aux = _layer_train(cfg, bp, shared, x, idx)
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


def head_loss(cfg: ModelConfig, params: dict, x: torch.Tensor, tokens: torch.Tensor,
              p_front: int = 0) -> torch.Tensor:
    """Final norm, head and the mean next-token CE of hidden states ``x``
    (B, P + T, D) against ``tokens`` (B, T): with ``p_front`` frontend rows
    ahead of the tokens, position P - 1 predicts the first token."""
    h = rmsnorm(params["final_ln"], x)
    if p_front:
        h, tokens = h[:, p_front - 1:p_front + tokens.shape[1] - 1], tokens
    else:
        h, tokens = h[:, :-1], tokens[:, 1:]
    if cfg.tie_embeddings:        # head_logits' scaling: on h, not on a copy of the table
        h, w = h * cfg.d_model ** -0.5, params["embed"]["tok"].t()
    else:
        w = params["head"]["w"]
    return chunked_xent(h, w, tokens, cfg.vocab_size)


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor],
                 cdt: torch.dtype) -> torch.Tensor:
    """The residual stream's input (B, P + T, D): the frontend rows, where
    the batch has them, then the tokens' embeddings."""
    x = embed_tokens(params["embed"], batch["tokens"].long(), cdt)
    if "frontend" in batch:
        x = torch.cat([batch["frontend"].to(cdt), x], dim=1)
    return x


def lm_loss(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            rcfg: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of ``batch["tokens"]`` (B, T), after ``batch["frontend"]``
    where given: (loss, {"ce", "aux"}), ``loss = ce + AUX_COEF * aux`` with
    ``aux`` the MoE balance losses summed over the layers (0 without MoE)."""
    cdt = dtype_of(rcfg.compute_dtype)
    tokens = batch["tokens"].long()
    x = embed_inputs(params, batch, cdt)
    x, aux = layers_train(cfg, params["blocks"], params.get("shared"), x, rcfg)
    ce = head_loss(cfg, params, x, tokens, x.shape[1] - tokens.shape[1])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}


def _prefill_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    max_len: int) -> Tuple[torch.Tensor, dict]:
    """Every layer of ``params["blocks"]`` over the residual stream ``x``
    (B,T,D): (x after the last of them, the cache: every layer's content,
    zamba2's ``ak``/``av``, ``pos`` still 0)."""
    bsz, t = x.shape[:2]
    span = cache_span(cfg, max_len)
    rope = None if cfg.rwkv else rope_tables(torch.arange(t, device=x.device)[None, :],
                                              cfg.head_dim, cfg.rope_theta)
    cache = init_cache(cfg, bsz, max_len, x.dtype, x.device)
    shared = params.get("shared")
    for i, bp in enumerate(params["blocks"]):
        x, cl = B.block_prefill(cfg, bp, x, rope, span)
        for name, leaf in cl.items():
            cache["layers"][name][i].copy_(leaf)
        if shared is not None:
            x = B.shared_attn_prefill(cfg, shared, x, i, rope, cache["ak"], cache["av"])
    return x, cache


def lm_stage_prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                     rcfg: RunConfig, max_len: int, *, first: bool = True,
                     last: bool = True) -> Tuple[torch.Tensor, dict]:
    """Prefill ONE stage of a layer-split model (paper §4.1 topology); the
    full model is the one stage that is first and last (:func:`lm_prefill`).

    ``cfg.n_layers`` is the STAGE's layer count and ``params["blocks"]``
    holds only those layers (:func:`repro_torch.models.api.split_stage_params`).
    The first stage embeds ``batch["tokens"]`` (after ``batch["frontend"]``'s
    rows where given); later stages continue the
    residual stream from ``batch["hidden"]``, the boundary activation the
    previous stage shipped.  Non-last stages return the FULL hidden
    sequence (B, T, D) so the next stage can prefill from it; the last
    stage returns last-token logits.  A cut only pauses the full model's
    layer loop, so the stages composed are bit-identical to it."""
    cdt = dtype_of(rcfg.compute_dtype)
    x = embed_inputs(params, batch, cdt) if first else batch["hidden"].to(cdt)
    x, cache = _prefill_layers(cfg, params, x, max_len)
    cache["pos"].fill_(x.shape[1])
    if last:
        return head_logits(cfg, params, rmsnorm(params["final_ln"], x)[:, -1]), cache
    return x, cache


def lm_prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
               rcfg: RunConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """Process a prompt; return (last-token logits (B, Vp), cache)."""
    return lm_stage_prefill(cfg, params, batch, rcfg, max_len)


def lm_prefill_padded(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                      lengths: torch.Tensor, rcfg: RunConfig,
                      max_len: int) -> Tuple[torch.Tensor, dict]:
    """Batched prefill of right-padded prompts with true ``lengths`` (B,).

    Exact for full causal attention: pad tokens sit strictly after every real
    token, so causality keeps them out of all real hidden states, the logits
    are gathered at each lane's last real position, and the per-lane cache
    ``pos`` masks the pad garbage out of decode until the step that
    overwrites it."""
    x = embed_inputs(params, batch, dtype_of(rcfg.compute_dtype))
    x, cache = _prefill_layers(cfg, params, x, max_len)
    x = rmsnorm(params["final_ln"], x)
    h = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]
    logits = head_logits(cfg, params, h)
    cache["pos"].copy_(lengths)
    return logits, cache


def lm_stage_decode_step(cfg: ModelConfig, params: dict, cache: dict, x_in: torch.Tensor,
                         rcfg: RunConfig, *, first: bool = True,
                         last: bool = True) -> Tuple[torch.Tensor, dict]:
    """One decode step of ONE stage over dense K/V lanes; the full dense
    model is the one stage that is first and last (:func:`lm_decode_step`).
    ``x_in`` is tokens (B, 1) int on the first stage, the previous stage's
    boundary activations (B, 1, D) otherwise.  Returns last-token logits on
    the last stage, the boundary hidden (B, 1, D) to ship onward everywhere
    else; the K/V of ``cache["layers"]`` are written in place."""
    cdt = dtype_of(rcfg.compute_dtype)
    x = embed_tokens(params["embed"], x_in, cdt) if first else x_in.to(cdt)
    pos = cache["pos"]
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    rows, valid = decode_slots(cfg, pos, ks.shape[2])
    for i, bp in enumerate(params["blocks"]):
        x = B.block_decode(cfg, bp, x, ks[i], vs[i], rope, rows, valid)
    cache = {"layers": cache["layers"], "pos": pos + 1}
    if last:
        return head_logits(cfg, params, rmsnorm(params["final_ln"], x)[:, -1]), cache
    return x, cache


def lm_decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                   rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) int.  Returns (logits (B,Vp), cache);
    the K/V or recurrent state of ``cache["layers"]`` (and zamba2's
    ``ak``/``av``) are updated in place."""
    if B.is_recurrent(cfg):
        return _decode_step_recurrent(cfg, params, cache, tokens, rcfg)
    return lm_stage_decode_step(cfg, params, cache, tokens, rcfg)


def lm_decode_window(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                     rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """W sequential decode steps (speculative verify).  tokens: (B, W) int,
    W consecutive next-token inputs per lane.  Returns (logits (B, W, Vp),
    the logits after each token, and the cache advanced by W positions).

    A Python loop of the very same :func:`lm_decode_step` call, not a
    parallel multi-token attention window: a parallel window changes the
    reduction shapes, and with them the rounding, which breaks the bitwise
    greedy identity speculative verification rests on.  So the window's
    logits and cache are bitwise those of W single steps, for every family
    :func:`lm_decode_step` serves (rwkv6 and zamba2 included)."""
    out = []
    for j in range(tokens.shape[1]):
        logits, cache = lm_decode_step(cfg, params, cache, tokens[:, j:j + 1], rcfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def _decode_step_recurrent(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                           rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """:func:`lm_decode_step` of rwkv and zamba2: every layer by its token
    recurrence, zamba2's shared block by the decode kernel over its slot."""
    cdt = dtype_of(rcfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, cdt)
    pos = cache["pos"]
    layers = cache["layers"]
    shared = params.get("shared")
    if shared is not None:
        ak, av = cache["ak"], cache["av"]
        rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        rows, valid = decode_slots(cfg, pos, ak.shape[2])
    for i, bp in enumerate(params["blocks"]):
        x = B.block_decode_recurrent(cfg, bp, x, {k: v[i] for k, v in layers.items()})
        if shared is not None:
            x = B.shared_attn_decode(cfg, shared, x, i, ak, av, rope, rows, valid)
    x = rmsnorm(params["final_ln"], x)
    logits = head_logits(cfg, params, x[:, -1])
    return logits, {**cache, "pos": pos + 1}


def lm_decode_step_pool(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                        block_tables: torch.Tensor,
                        rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step against a block-pooled (paged) KV cache.

    cache: {"layers": {"k"/"v": (L, NB+1, bs, KVH, Dh)}, "pos": (B,)};
    block_tables: (B, max_blocks) int32 pool block ids (0 = sink), on the
    cache's device.  tokens: (B, 1) int.  Returns (logits (B, Vp), cache);
    the pools of ``cache["layers"]`` are updated in place."""
    cdt = dtype_of(rcfg.compute_dtype)
    x = embed_tokens(params["embed"], tokens, cdt)
    pos = cache["pos"]
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    rows, p_eff = paged_slots(pos, block_tables, ks.shape[2])
    for i, bp in enumerate(params["blocks"]):
        x = B.block_decode_paged(cfg, bp, x, ks[i], vs[i], rope, rows, block_tables, p_eff)
    x = rmsnorm(params["final_ln"], x)
    logits = head_logits(cfg, params, x[:, -1])
    return logits, {"layers": cache["layers"], "pos": pos + 1}


def lm_decode_window_pool(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                          block_tables: torch.Tensor,
                          rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """W sequential pooled decode steps (paged verify): the contract and the
    bitwise rationale of :func:`lm_decode_window`, looping
    :func:`lm_decode_step_pool` over one set of block tables."""
    out = []
    for j in range(tokens.shape[1]):
        logits, cache = lm_decode_step_pool(cfg, params, cache, tokens[:, j:j + 1],
                                            block_tables, rcfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
               device) -> dict:
    """The zeroed decode cache of ``batch`` lanes (the module docstring's
    layouts): K/V lanes, or the recurrent state of every layer and zamba2's
    shared-block slots."""
    if cfg.rwkv:
        layers = rwkv_mod.init_rwkv6_state(cfg, batch, cfg.n_layers, dtype, device)
    elif B.is_mamba(cfg):
        layers = ssm_mod.init_mamba2_state(cfg, batch, cfg.n_layers, dtype, device)
    else:
        layers = init_kv_cache(cfg, batch, max_len, dtype, device)
    cache = {"layers": layers, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    n_attn = B.n_attn_applications(cfg)
    if n_attn:
        shape = (n_attn, batch, cache_span(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
        cache["ak"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["av"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def init_pool_cache(cfg: ModelConfig, n_lanes: int, n_blocks: int, block_size: int,
                    dtype: torch.dtype, device) -> dict:
    """Pooled KV cache: ``n_blocks`` usable blocks + 1 sink (block id 0),
    sized by live tokens rather than lanes x worst-case length; per-lane
    block tables (backend-owned) map logical positions to pool slots."""
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)},
            "pos": torch.zeros((n_lanes,), dtype=torch.int32, device=device)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell (the
    reference's ``ShapeDtypeStruct``s): train/prefill ``{"tokens",
    ["frontend"]}``, decode ``{"tokens" (B, 1), "cache"}`` with the cache of
    ``shape.seq_len`` positions built on ``meta``."""
    cdt, meta = dtype_of(rcfg.compute_dtype), torch.device("meta")
    bsz = shape.global_batch
    p = cfg.frontend_seq if cfg.frontend else 0
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((bsz, shape.seq_len - p), dtype=torch.int32, device=meta)}
        if p:
            specs["frontend"] = torch.empty((bsz, p, cfg.d_model), dtype=cdt, device=meta)
        return specs
    return {"tokens": torch.empty((bsz, 1), dtype=torch.int32, device=meta),
            "cache": init_cache(cfg, bsz, shape.seq_len, cdt, meta)}
