"""AdamW with fp32 moments, global-norm clipping and LR schedules (port of
``repro/optim/adamw.py``).

Plain functions on trees (dicts, lists) of tensors, run under
``torch.no_grad()``; ``torch.optim.AdamW`` is not used, so the reference's
arithmetic stays exactly its own: clip-by-global-norm, the warmup + cosine
/ linear / const schedule, bias correction, ``eps`` added to the square
root, and no weight decay on leaves with ``ndim < 2``.  The step counter
and every schedule scalar stay on the device, so an update never waits
for the host.

Unlike the reference, :func:`update` writes the new params and moments in
place (bf16 params are updated in fp32 and cast back) and returns the same
trees: the old values are not needed after a step, and at rwkv6-1.6b a
second copy of params and moments would cost 16 GB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.convert import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | linear | const


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int tensor), a float32 tensor on its device."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
    return cfg.lr * warm * decay


def init(params: Any) -> Dict[str, Any]:
    """Zero fp32 moments shaped like ``params`` and a step counter, on the
    params' device."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(iter(leaves(params))).device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves(tree)])))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, opt_state: Dict[str, Any],
           params: Any) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, opt_state, stats), params and moments
    updated in place.  ``grads`` has the structure of ``params``."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32) + 1
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"])):
        g32 = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay and p.ndim >= 2:          # no decay on norms/bias
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
