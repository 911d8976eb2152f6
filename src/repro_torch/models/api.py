"""Model protocol (port of ``repro/models/api.py``).

    model = build_model(cfg, rcfg, device="cuda")
    params = model.init(seed)
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens)

``model.decode_state`` (a :class:`DecodeState`) tells the serving backends
what the decode state supports; ``batched_prefill`` is set only where
right-padding is provably inert (full causal attention).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm as LM
from repro_torch.models.blocks import require_dense


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """``kind`` is the state taxonomy ("attention" for every family the port
    serves); ``batched_prefill(params, batch, lengths, max_len)`` is the
    right-padded bucketed prefill, or None where padding would leak."""

    kind: str
    batched_prefill: Optional[
        Callable[[dict, Dict[str, torch.Tensor], torch.Tensor, int],
                 Tuple[torch.Tensor, dict]]] = None


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


def _no_loss(*_a, **_k):
    raise NotImplementedError("training (lm_loss, AdamW, flash backward) is ROADMAP §1 "
                              "item 4, the port's training slice")


def build_model(cfg: ModelConfig, rcfg: RunConfig, device="cuda") -> Model:
    """The model's entry points on ``device`` (default ``cuda``).

    Dense decoder LMs only; other families raise NotImplementedError naming
    their ROADMAP item.  Params and compute share one dtype here."""
    require_dense(cfg)
    if rcfg.param_dtype != rcfg.compute_dtype:
        raise ValueError(f"repro_torch runs with param_dtype == compute_dtype, got "
                         f"{rcfg.param_dtype!r} and {rcfg.compute_dtype!r}")
    device = torch.device(device)
    dt = LM.dtype_of(rcfg.param_dtype)

    def init(seed: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(seed)
        return LM.init_lm(cfg, gen, dt)

    batched = None
    if cfg.attention == "full":
        def batched(p, b, ln, ml):
            return LM.lm_prefill_padded(cfg, p, b, ln, rcfg, ml)

    return Model(
        cfg=cfg, rcfg=rcfg, device=device,
        init=init,
        loss=_no_loss,
        prefill=lambda p, b, ml: LM.lm_prefill(cfg, p, b, rcfg, ml),
        decode_step=lambda p, c, t: LM.lm_decode_step(cfg, p, c, t, rcfg),
        init_cache=lambda bsz, ml: LM.init_cache(cfg, bsz, ml, dt, device),
        decode_state=DecodeState(kind="attention", batched_prefill=batched),
    )
