"""Model protocol (port of ``repro/models/api.py``).

    model = build_model(cfg, rcfg, device="cuda")
    params = model.init(seed)
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens)
    loss, aux = model.loss(params, batch)

Every ported family (dense, rwkv, hybrid) trains and serves.
``model.decode_state`` (a :class:`DecodeState`) tells the serving backends
what the decode state supports; ``batched_prefill`` is set only where
right-padding is provably inert (full causal attention), and the block-pool
pair ``pool_init`` / ``pool_step`` only where the decode state is a
position-addressed K/V cache (full attention).  rwkv and zamba2 carry a
recurrent state: each request is prefilled alone at its exact length, and
the ``RecurrentBackend`` serves them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm as LM
from repro_torch.models.blocks import is_recurrent, require_ported


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """``kind`` is the state taxonomy ("attention" for the dense family,
    "recurrent" for rwkv and zamba2: a constant-size state per lane,
    cheap to snapshot and restore);
    ``batched_prefill(params, batch, lengths, max_len)`` is the
    right-padded bucketed prefill, or None where padding would leak.

    ``pool_init(n_lanes, n_blocks, block_size)`` / ``pool_step(params,
    cache, tokens, block_tables)`` are the paged layout's cache constructor
    and decode step (:func:`repro_torch.models.lm.init_pool_cache` /
    :func:`~repro_torch.models.lm.lm_decode_step_pool`); ``poolable`` says
    whether they exist."""

    kind: str
    batched_prefill: Optional[
        Callable[[dict, Dict[str, torch.Tensor], torch.Tensor, int],
                 Tuple[torch.Tensor, dict]]] = None
    pool_init: Optional[Callable[[int, int, int], dict]] = None
    pool_step: Optional[
        Callable[[dict, dict, torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, dict]]] = None

    @property
    def poolable(self) -> bool:
        return self.pool_step is not None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rcfg: RunConfig
    device: torch.device
    init: Callable[[int], dict]
    loss: Callable[..., Tuple[torch.Tensor, dict]]
    prefill: Callable[[dict, Dict[str, torch.Tensor], int], Tuple[torch.Tensor, dict]]
    decode_step: Callable[[dict, dict, torch.Tensor], Tuple[torch.Tensor, dict]]
    init_cache: Callable[[int, int], dict]
    decode_state: DecodeState = DecodeState(kind="attention")


def build_model(cfg: ModelConfig, rcfg: RunConfig, device="cuda") -> Model:
    """The model's entry points on ``device`` (default ``cuda``).

    Dense decoder LMs, rwkv6 and zamba2 train and serve; other families
    raise naming their ROADMAP item.  Params and compute share one dtype
    here."""
    require_ported(cfg)
    if rcfg.param_dtype != rcfg.compute_dtype:
        raise ValueError(f"repro_torch runs with param_dtype == compute_dtype, got "
                         f"{rcfg.param_dtype!r} and {rcfg.compute_dtype!r}")
    device = torch.device(device)
    dt = LM.dtype_of(rcfg.param_dtype)

    def init(seed: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(seed)
        return LM.init_lm(cfg, gen, dt)

    # right-padded batched prefill and the block pool are both exact only
    # for full causal attention (the reference's ragged_ok / pool_ok gates,
    # restricted to the families the port builds): recurrent state folds
    # pad tokens in and is not position-addressed; chunked_local's ring
    # buffer is dense-span specific
    recurrent = is_recurrent(cfg)
    batched = pool_init = pool_step = None
    if cfg.attention == "full" and not recurrent:
        def batched(p, b, ln, ml):
            return LM.lm_prefill_padded(cfg, p, b, ln, rcfg, ml)

        def pool_init(nl, nb, bs):
            return LM.init_pool_cache(cfg, nl, nb, bs, dt, device)

        def pool_step(p, c, t, bt):
            return LM.lm_decode_step_pool(cfg, p, c, t, bt, rcfg)

    return Model(
        cfg=cfg, rcfg=rcfg, device=device,
        init=init,
        loss=lambda p, b: LM.lm_loss(cfg, p, b, rcfg),
        prefill=lambda p, b, ml: LM.lm_prefill(cfg, p, b, rcfg, ml),
        decode_step=lambda p, c, t: LM.lm_decode_step(cfg, p, c, t, rcfg),
        init_cache=lambda bsz, ml: LM.init_cache(cfg, bsz, ml, dt, device),
        decode_state=DecodeState(kind="recurrent" if recurrent else "attention",
                                 batched_prefill=batched, pool_init=pool_init,
                                 pool_step=pool_step),
    )
