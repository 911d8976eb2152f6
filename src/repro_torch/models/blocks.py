"""Per-layer decoder blocks (port of ``repro/models/blocks.py``, dense branch).

    init_block(gen, cfg, dtype)                      -> one layer's params
    block_prefill(cfg, bp, x, rope, span)                 -> (x, {"k", "v"})
    block_decode(cfg, bp, x, ck, cv, rope, rows, valid)   -> x  (ck/cv in place)

``rope`` / ``rows`` / ``valid`` depend only on positions, so the assembly
computes them once per forward for all layers.

The layer-stacked cache is allocated whole by
:func:`repro_torch.models.attention.init_kv_cache`, so the reference's
one-layer ``init_cache_layer`` has no counterpart here.

Other families (MoE, SSM, RWKV, the hybrid shared block) are not ported yet
(ROADMAP §1 item 10); :func:`require_dense` names that item.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_mlp, init_mlp, init_rmsnorm, rmsnorm


def require_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.rwkv or cfg.n_experts or cfg.frontend
            or cfg.n_enc_layers):
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP §1 item 10, other families); only dense decoder LMs are")


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    require_dense(cfg)
    d = cfg.d_model
    return {"ln1": init_rmsnorm(d, dtype, gen.device), "ln2": init_rmsnorm(d, dtype, gen.device),
            "attn": attn.init_attention(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype)}


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
