"""Per-layer decoder blocks (port of ``repro/models/blocks.py``: dense, rwkv
and the hybrid family's Mamba2 layers and shared block).

    init_block(gen, cfg, dtype)                      -> one layer's params
    init_shared(gen, cfg, dtype)                     -> zamba2's shared block, or None
    block_train(cfg, bp, x)                               -> x  (full sequence, no cache)
    shared_attn_train(cfg, shared, x, idx)                -> x  (fires every attn_every)
    block_prefill(cfg, bp, x, rope, span)                 -> (x, {"k", "v"})
    block_decode(cfg, bp, x, ck, cv, rope, rows, valid)   -> x  (ck/cv in place)
    block_decode_paged(cfg, bp, x, kp, vp, rope, rows, block_tables, p_eff)
                                                          -> x  (kp/vp in place)

``rope`` / ``rows`` / ``valid`` / ``p_eff`` depend only on positions, so the
assembly computes them once per forward for all layers.

The layer-stacked cache is allocated whole by
:func:`repro_torch.models.attention.init_kv_cache`, so the reference's
one-layer ``init_cache_layer`` has no counterpart here.  The reference's
per-layer MoE auxiliary loss is 0 for the families here, so
:func:`block_train` returns x alone.

rwkv and hybrid (zamba2) blocks train (``block_train``, and the shared
attention+MLP block, one set of weights fired by the assembly every
``attn_every`` layers) but do not serve yet: recurrent serving comes with
the ``RecurrentBackend`` (ROADMAP §1).  Other families (MoE, pure SSM,
enc-dec, frontends) are not ported yet (ROADMAP §1 item 10);
:func:`require_ported` names that item.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_mlp, init_mlp, init_rmsnorm, rmsnorm


def require_ported(cfg: ModelConfig) -> None:
    """Dense decoder LMs, rwkv6 and the hybrid family are ported; other
    families raise."""
    if cfg.rwkv:
        return
    if (cfg.family not in ("dense", "hybrid") or cfg.n_experts or cfg.frontend
            or cfg.n_enc_layers):
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP §1 item 10, other families); dense decoder LMs, rwkv6 and the hybrid "
            f"family (zamba2) are")


def is_recurrent(cfg: ModelConfig) -> bool:
    """rwkv and zamba2 carry a recurrent state when they serve."""
    return cfg.rwkv or cfg.family == "hybrid"


def require_kv_serving(cfg: ModelConfig) -> None:
    """The serving entry points take families with a K/V cache: rwkv's and
    zamba2's recurrent state is served by the ``RecurrentBackend``, not
    ported yet."""
    require_ported(cfg)
    if is_recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id}: recurrent serving (the RecurrentBackend; rwkv/ssm prefill and "
            f"decode) is not ported to repro_torch yet (ROADMAP §1 item 13); it trains")


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    require_ported(cfg)
    d = cfg.d_model
    ln = lambda: init_rmsnorm(d, dtype, gen.device)
    if cfg.rwkv:
        return {"ln1": ln(), "ln2": ln(), "rwkv": rwkv_mod.init_rwkv6(gen, cfg, dtype)}
    if cfg.family == "hybrid":
        return {"ln": ln(), "mamba": ssm_mod.init_mamba2(gen, cfg, dtype)}
    return {"ln1": ln(), "ln2": ln(), "attn": attn.init_attention(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype)}


def init_shared(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Optional[dict]:
    """zamba2: one shared attention+MLP block applied every ``attn_every``."""
    if cfg.family == "hybrid" and cfg.attn_every:
        d = cfg.d_model
        return {"ln1": init_rmsnorm(d, dtype, gen.device),
                "attn": attn.init_attention(gen, cfg, dtype),
                "ln2": init_rmsnorm(d, dtype, gen.device),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.glu, dtype)}
    return None


def n_attn_applications(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid" and cfg.attn_every:
        return -(-cfg.n_layers // cfg.attn_every)      # ceil
    return 0


def block_train(cfg: ModelConfig, bp: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer over a full sequence from an empty state (training)."""
    if cfg.rwkv:
        x = x + rwkv_mod.apply_rwkv6_tmix(bp["rwkv"], cfg, rmsnorm(bp["ln1"], x))
        return x + rwkv_mod.apply_rwkv6_cmix(bp["rwkv"], cfg, rmsnorm(bp["ln2"], x))
    if cfg.family == "hybrid":
        return x + ssm_mod.apply_mamba2(bp["mamba"], cfg, rmsnorm(bp["ln"], x))
    x = x + attn.attention(bp["attn"], cfg, rmsnorm(bp["ln1"], x), causal=True)
    return x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)


def shared_attn_train(cfg: ModelConfig, shared: dict, x: torch.Tensor,
                      idx: int) -> torch.Tensor:
    """zamba2's shared block after layer ``idx``: fires when ``idx %
    attn_every == 0``, else passes x through."""
    if idx % cfg.attn_every:
        return x
    h = x + attn.attention(shared["attn"], cfg, rmsnorm(shared["ln1"], x), causal=True)
    return h + apply_mlp(shared["mlp"], rmsnorm(shared["ln2"], h), cfg.act)


def block_prefill(cfg: ModelConfig, bp: dict, x: torch.Tensor, rope: attn.Rope,
                  span: int) -> Tuple[torch.Tensor, dict]:
    dtype = x.dtype
    h, ck, cv = attn.prefill_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), rope, span)
    x = x + h
    x = x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)
    return x, {"k": ck.to(dtype), "v": cv.to(dtype)}


def block_decode(cfg: ModelConfig, bp: dict, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, rope: attn.Rope, rows: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """One-token step of one layer; writes this token's K/V into ck/cv in place."""
    x = x + attn.decode_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), ck, cv, rope, rows,
                             valid)
    return x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)


def block_decode_paged(cfg: ModelConfig, bp: dict, x: torch.Tensor, kp: torch.Tensor,
                       vp: torch.Tensor, rope: attn.Rope, rows: torch.Tensor,
                       block_tables: torch.Tensor, p_eff: torch.Tensor) -> torch.Tensor:
    """One-token step of one layer against a paged KV pool; writes this
    token's K/V into kp/vp in place."""
    x = x + attn.decode_attn_paged(bp["attn"], cfg, rmsnorm(bp["ln1"], x), kp, vp, rope, rows,
                                   block_tables, p_eff)
    return x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)
