"""Per-layer decoder blocks (port of ``repro/models/blocks.py``: dense and
MoE attention layers, rwkv, and the Mamba2 layers of the pure-SSM and
hybrid families with zamba2's shared block).

    init_block(gen, cfg, dtype)                      -> one layer's params
    init_shared(gen, cfg, dtype)                     -> zamba2's shared block, or None
    block_train(cfg, bp, x)                               -> (x, aux)  (full sequence, no cache)
    shared_attn_train(cfg, shared, x, idx)                -> x  (fires every attn_every)
    block_prefill(cfg, bp, x, rope, span)                 -> (x, cache layer)
    block_decode(cfg, bp, x, ck, cv, rope, rows, valid)   -> x  (ck/cv in place)
    block_decode_paged(cfg, bp, x, kp, vp, rope, rows, block_tables, p_eff)
                                                          -> x  (kp/vp in place)
    block_decode_recurrent(cfg, bp, x, st)                -> x  (st in place)
    shared_attn_prefill(cfg, shared, x, idx, rope, ak, av)           -> x  (slot in place)
    shared_attn_decode(cfg, shared, x, idx, ak, av, rope, rows, valid) -> x  (slot in place)

``rope`` / ``rows`` / ``valid`` / ``p_eff`` depend only on positions, so the
assembly computes them once per forward for all layers.  A cache layer is
``{"k", "v"}`` for the attention families, ``{"S", "last", "last_c"}`` for
rwkv and ``{"conv", "ssm"}`` for Mamba2 layers; zamba2's shared block keeps
its K/V in the ``ak``/``av`` slots, one per firing (slot ``idx //
attn_every``).

An MoE layer's feed-forward is :func:`repro_torch.models.moe.apply_moe`,
called through the module (so a caller may wrap it): over a prompt with
the reference's 4096-token groups, at a decode step with the lanes as one
group.  Its balance loss is ``block_train``'s ``aux`` (0 elsewhere).

The layer-stacked cache is allocated whole by
:func:`repro_torch.models.lm.init_cache`, so the reference's one-layer
``init_cache_layer`` has no counterpart here.  The encoder-decoder family
has blocks of its own (:mod:`repro_torch.models.encdec`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_mlp, init_mlp, init_rmsnorm, rmsnorm


def is_mamba(cfg: ModelConfig) -> bool:
    """Mamba2 layers: the pure-SSM family and zamba2's backbone."""
    return not cfg.rwkv and cfg.family in ("ssm", "hybrid")


def is_recurrent(cfg: ModelConfig) -> bool:
    """rwkv, the pure-SSM family and zamba2 carry a recurrent state when
    they serve."""
    return cfg.rwkv or is_mamba(cfg)


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    ln = lambda: init_rmsnorm(d, dtype, gen.device)
    if cfg.rwkv:
        return {"ln1": ln(), "ln2": ln(), "rwkv": rwkv_mod.init_rwkv6(gen, cfg, dtype)}
    if is_mamba(cfg):
        return {"ln": ln(), "mamba": ssm_mod.init_mamba2(gen, cfg, dtype)}
    p = {"ln1": ln(), "ln2": ln(), "attn": attn.init_attention(gen, cfg, dtype)}
    if cfg.n_experts:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype)
    return p


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


def _ffn(cfg: ModelConfig, bp: dict, x: torch.Tensor,
         group_size: int = 4096) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual ``x`` plus the layer's MLP or MoE of ``rmsnorm(ln2, x)``,
    and the MoE's balance loss (None for an MLP)."""
    h = rmsnorm(bp["ln2"], x)
    if cfg.n_experts:
        y, aux = moe_mod.apply_moe(bp["moe"], cfg, h, group_size=group_size)
        return x + y, aux
    return x + apply_mlp(bp["mlp"], h, cfg.act), None


def block_train(cfg: ModelConfig, bp: dict,
                x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer over a full sequence from an empty state (training):
    (x, the MoE balance loss or None where the layer has none)."""
    if cfg.rwkv:
        x = x + rwkv_mod.apply_rwkv6_tmix(bp["rwkv"], cfg, rmsnorm(bp["ln1"], x))[0]
        return x + rwkv_mod.apply_rwkv6_cmix(bp["rwkv"], cfg, rmsnorm(bp["ln2"], x))[0], None
    if is_mamba(cfg):
        return x + ssm_mod.apply_mamba2(bp["mamba"], cfg, rmsnorm(bp["ln"], x))[0], None
    x = x + attn.attention(bp["attn"], cfg, rmsnorm(bp["ln1"], x), causal=True)
    return _ffn(cfg, bp, x)


def shared_attn_train(cfg: ModelConfig, shared: dict, x: torch.Tensor,
                      idx: int) -> torch.Tensor:
    """zamba2's shared block after layer ``idx``: fires when ``idx %
    attn_every == 0``, else passes x through."""
    if idx % cfg.attn_every:
        return x
    h = x + attn.attention(shared["attn"], cfg, rmsnorm(shared["ln1"], x), causal=True)
    return h + apply_mlp(shared["mlp"], rmsnorm(shared["ln2"], h), cfg.act)


def block_prefill(cfg: ModelConfig, bp: dict, x: torch.Tensor, rope: Optional[attn.Rope],
                  span: int) -> Tuple[torch.Tensor, dict]:
    """One layer over a prompt from the empty state: (x, the layer's cache
    content).  rwkv and Mamba2 layers take their scan kernels and ignore
    ``rope``/``span``."""
    dtype = x.dtype
    if cfg.rwkv:
        h, st = rwkv_mod.apply_rwkv6_tmix(bp["rwkv"], cfg, rmsnorm(bp["ln1"], x),
                                          keep_state=True)
        x = x + h
        h, last_c = rwkv_mod.apply_rwkv6_cmix(bp["rwkv"], cfg, rmsnorm(bp["ln2"], x))
        return x + h, {"S": st["S"], "last": st["last"], "last_c": last_c}
    if is_mamba(cfg):
        h, st = ssm_mod.apply_mamba2(bp["mamba"], cfg, rmsnorm(bp["ln"], x))
        return x + h, st
    h, ck, cv = attn.prefill_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), rope, span)
    x, _ = _ffn(cfg, bp, x + h)
    return x, {"k": ck.to(dtype), "v": cv.to(dtype)}


def block_decode(cfg: ModelConfig, bp: dict, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, rope: attn.Rope, rows: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """One-token step of one layer; writes this token's K/V into ck/cv in place."""
    x = x + attn.decode_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), ck, cv, rope, rows,
                             valid)
    return _ffn(cfg, bp, x, group_size=max(1, x.shape[0]))[0]


def block_decode_paged(cfg: ModelConfig, bp: dict, x: torch.Tensor, kp: torch.Tensor,
                       vp: torch.Tensor, rope: attn.Rope, rows: torch.Tensor,
                       block_tables: torch.Tensor, p_eff: torch.Tensor) -> torch.Tensor:
    """One-token step of one layer against a paged KV pool; writes this
    token's K/V into kp/vp in place."""
    x = x + attn.decode_attn_paged(bp["attn"], cfg, rmsnorm(bp["ln1"], x), kp, vp, rope, rows,
                                   block_tables, p_eff)
    return _ffn(cfg, bp, x, group_size=max(1, x.shape[0]))[0]


def block_decode_recurrent(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                           st: dict) -> torch.Tensor:
    """One-token step of an rwkv or Mamba2 layer by the token recurrence (no
    kernel but RMSNorm, as the reference's decode); ``st`` holds the
    layer's state leaves (views into the stacked cache), overwritten in
    place with the state after x."""
    if cfg.rwkv:
        h, new = rwkv_mod.apply_rwkv6_tmix(bp["rwkv"], cfg, rmsnorm(bp["ln1"], x),
                                           state={"S": st["S"], "last": st["last"]})
        x = x + h
        h, new["last_c"] = rwkv_mod.apply_rwkv6_cmix(bp["rwkv"], cfg, rmsnorm(bp["ln2"], x),
                                                     state={"last_c": st["last_c"]})
    else:
        h, new = ssm_mod.apply_mamba2(bp["mamba"], cfg, rmsnorm(bp["ln"], x), state=st)
    for name, t in new.items():
        st[name].copy_(t)
    return x + h


def shared_attn_prefill(cfg: ModelConfig, shared: dict, x: torch.Tensor, idx: int,
                        rope: attn.Rope, ak: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """zamba2's shared block after layer ``idx`` over a prompt: where it
    fires, its K/V go into slot ``idx // attn_every`` of the stacked slots
    ak/av (n_attn, B, span, KVH, Dh), in place; else x passes through."""
    if idx % cfg.attn_every:
        return x
    slot = idx // cfg.attn_every
    h, ck, cv = attn.prefill_attn(shared["attn"], cfg, rmsnorm(shared["ln1"], x), rope,
                                  ak.shape[2])
    ak[slot].copy_(ck)
    av[slot].copy_(cv)
    y = x + h
    return y + apply_mlp(shared["mlp"], rmsnorm(shared["ln2"], y), cfg.act)


def shared_attn_decode(cfg: ModelConfig, shared: dict, x: torch.Tensor, idx: int,
                       ak: torch.Tensor, av: torch.Tensor, rope: attn.Rope, rows: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """One-token step of zamba2's shared block after layer ``idx``: where it
    fires, the decode kernel reads slot ``idx // attn_every`` and this
    token's K/V are written into it.  ``ak[slot]`` with an int slot is a
    view, so the write lands in the stacked tensor (an index tensor would
    copy the slot and drop the write)."""
    if idx % cfg.attn_every:
        return x
    slot = idx // cfg.attn_every
    y = x + attn.decode_attn(shared["attn"], cfg, rmsnorm(shared["ln1"], x), ak[slot], av[slot],
                             rope, rows, valid)
    return y + apply_mlp(shared["mlp"], rmsnorm(shared["ln2"], y), cfg.act)
