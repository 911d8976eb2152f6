"""Mixture-of-Experts: GShard/Switch-style grouped top-k dispatch (port of
``repro/models/moe.py``).

Tokens are split into groups; within each group a router (fp32) picks each
token's top-k experts by first argmax, gates are the raw probabilities (not
renormalised), each expert takes at most ``cap`` tokens of a group in token
order (the rest are dropped), and a Switch load-balancing loss is returned
beside the output.  Every semantic is the reference's, including the
capacity's Python ``int`` truncation and its cap at the group size, so at a
decode step the lanes of a batch share capacity (idle lanes included).

The dispatch here is written with indices: each kept (token, expert) pair
gets a slot ``(expert, group, position)``, the slots gather their tokens,
the experts run as batched matmuls over E, and the outputs are added back
to their tokens weighted by the gates (in fp32, rounded once).
:func:`apply_moe_plain` is the reference's one-hot einsum, line by line; the
tests and the card's checks hold :func:`apply_moe` to it.  Neither has a
kernel: the reference computes these products outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _ACTS, apply_mlp, init_mlp, truncated_normal


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Router (D, E) in fp32 whatever ``dtype``; experts (E, D, F) / (E, F, D)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": truncated_normal((d, e), s_in, torch.float32, gen),
         "wi": truncated_normal((e, d, f), s_in, dtype, gen),
         "wo": truncated_normal((e, f, d), s_out, dtype, gen)}
    if cfg.glu:
        p["wg"] = truncated_normal((e, d, f), s_in, dtype, gen)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * f, cfg.glu, dtype)
    return p


def groups(n_tok: int, group_size: int) -> Tuple[int, int]:
    """(G, N): the largest G <= max(1, n_tok // group_size) dividing n_tok,
    and the tokens per group."""
    g = max(1, n_tok // group_size)
    while n_tok % g:
        g -= 1
    return g, n_tok // g


def capacity(n: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots per expert and group: ``int(max(k, cf * n * k / e))``, at most n."""
    return min(int(max(k, capacity_factor * n * k / e)), n)


def _top_k_gating(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (G,N,E) -> (gates (G,N,E) zero except chosen, mask (G,N,E) bool):
    k rounds of first argmax, each zeroing its pick."""
    gates = torch.zeros_like(probs)
    mask = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    p = probs
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(p, dim=-1), probs.shape[-1]).to(probs.dtype)
        gates = gates + onehot * probs
        mask = mask | onehot.bool()
        p = p * (1.0 - onehot)
    return gates, mask


class Route(NamedTuple):
    """One call's routing: ``probs``/``gates`` (G,N,E) fp32, ``mask`` the
    top-k picks, ``pos`` each pick's place in its expert's queue, ``keep``
    the picks within capacity, ``cap`` the slots per (group, expert), and
    the Switch ``aux`` loss."""
    probs: torch.Tensor
    gates: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def route(params: dict, cfg: ModelConfig, xg: torch.Tensor,
          capacity_factor: float = 1.25) -> Route:
    """Routing of grouped tokens ``xg`` (G, N, D)."""
    e, k = cfg.n_experts, cfg.top_k
    n = xg.shape[1]
    logits = xg.float() @ params["router"].float()                  # (G,N,E)
    probs = torch.softmax(logits, dim=-1)
    gates, mask = _top_k_gating(probs, k)
    # load-balance loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e)
    frac = mask.float().mean(dim=1)                                 # (G,E)
    mean_p = probs.mean(dim=1)
    aux = e * torch.mean(torch.sum(frac * mean_p, dim=-1))
    cap = capacity(n, k, e, capacity_factor)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1             # queue place
    keep = mask & (pos < cap)
    return Route(probs, gates, mask, pos, keep, cap, aux)


def _experts(params: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its slots: xe (E, S, D) -> (E, S, D)."""
    h = torch.bmm(xe, params["wi"].to(xe.dtype))
    if "wg" in params:
        h = _ACTS[cfg.act](torch.bmm(xe, params["wg"].to(xe.dtype))) * h
    else:
        h = _ACTS[cfg.act](h)
    return torch.bmm(h, params["wo"].to(xe.dtype))


def apply_moe(params: dict, cfg: ModelConfig, x: torch.Tensor, capacity_factor: float = 1.25,
              group_size: int = 4096,
              rt: Optional[Route] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B,T,D), aux_loss scalar).  ``rt`` reuses a
    :func:`route` of the same grouped input (the card's checks pass one
    routing to both this and :func:`apply_moe_plain`)."""
    b, t, d = x.shape
    e = cfg.n_experts
    g, n = groups(b * t, group_size)
    xg = x.reshape(g, n, d)
    rt = route(params, cfg, xg, capacity_factor) if rt is None else rt
    cap = rt.cap
    n_slots = e * g * cap
    # slot of each kept (token, expert) pair, laid out (E, G, cap) so the
    # experts' inputs are one (E, G*cap, D) batch; dropped pairs go to a
    # trash slot past the end
    ge = (torch.arange(e, device=x.device) * g)[None, None, :] \
        + torch.arange(g, device=x.device)[:, None, None]           # (G,1,E)
    dest = torch.where(rt.keep, (ge * cap + rt.pos).long(), n_slots).reshape(-1)
    tok = torch.arange(g * n, device=x.device).reshape(g, n, 1).expand(g, n, e).reshape(-1)
    slot_tok = torch.full((n_slots + 1,), g * n, dtype=torch.long, device=x.device)
    slot_tok.scatter_(0, dest, tok)                 # kept slots are unique; trash is dropped
    slot_gate = torch.zeros((n_slots + 1,), dtype=x.dtype, device=x.device)
    slot_gate.scatter_(0, dest, rt.gates.to(x.dtype).reshape(-1))
    slot_tok, slot_gate = slot_tok[:n_slots], slot_gate[:n_slots]
    x_pad = torch.cat([xg.reshape(g * n, d), x.new_zeros((1, d))])   # row g*n: empty slot
    xe = x_pad.index_select(0, slot_tok).reshape(e, g * cap, d)
    ye = _experts(params, cfg, xe).reshape(n_slots, d)
    y = torch.zeros((g * n + 1, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, slot_tok, slot_gate.float()[:, None] * ye.float())
    y = y[:g * n].to(x.dtype).reshape(b, t, d)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, cfg.act)
    return y, rt.aux


def apply_moe_plain(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    capacity_factor: float = 1.25, group_size: int = 4096,
                    rt: Optional[Route] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` as the reference writes it: a one-hot dispatch
    tensor (G,N,E,C) and four einsums."""
    b, t, d = x.shape
    g, n = groups(b * t, group_size)
    xg = x.reshape(g, n, d)
    rt = route(params, cfg, xg, capacity_factor) if rt is None else rt
    cap, keep = rt.cap, rt.keep
    disp = F.one_hot(torch.where(keep, rt.pos, cap).long(), cap + 1).to(xg.dtype)[..., :cap]
    disp = disp * keep[..., None].to(xg.dtype)
    xe = torch.einsum("gnec,gnd->gecd", disp, xg)                   # (G,E,C,D)
    h = torch.einsum("gecd,edf->gecf", xe, params["wi"].to(xg.dtype))
    if "wg" in params:
        gate_h = torch.einsum("gecd,edf->gecf", xe, params["wg"].to(xg.dtype))
        h = _ACTS[cfg.act](gate_h) * h
    else:
        h = _ACTS[cfg.act](h)
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(xg.dtype))
    combine = disp * rt.gates.to(xg.dtype)[..., None]              # (G,N,E,C)
    y = torch.einsum("gnec,gecd->gnd", combine, ye).reshape(b, t, d)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, cfg.act)
    return y, rt.aux
