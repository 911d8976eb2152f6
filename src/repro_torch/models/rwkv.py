"""RWKV-6 (Finch) block, training forward (port of ``repro/models/rwkv.py``).

Time-mixing per head (K = V = head_dim):
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + LoRA(x~_t))) the data-dependent decay and
token-shift interpolation x~ = lerp(x_t, x_{t-1}, mu); channel-mixing is
the squared-relu RWKV FFN.  The reference's simplifications are kept
(static mu per projection, decay LoRA rank 64).

The WKV recurrence of a whole sequence goes through ``ops.rwkv6_scan``
(the chunked kernel on the card, its plain chunked version on the CPU).
:func:`rwkv6_scan_plain` is the token recurrence, the oracle both are held
to.  Recurrent serving (a carried state per lane, the reference's
``state=`` arguments and ``init_rwkv6_state``) comes with the
``RecurrentBackend`` (ROADMAP §1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import truncated_normal

LORA_RANK = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    s = d ** -0.5
    dev = gen.device
    tn = lambda shape, scale, dt=dtype: truncated_normal(shape, scale, dt, gen)
    return {
        # time-mix
        "mu": 0.5 * torch.ones((5, d), dtype=dtype, device=dev),   # r,k,v,w,g shift mixes
        "wr": tn((d, d), s),
        "wk": tn((d, d), s),
        "wv": tn((d, d), s),
        "wg": tn((d, d), s),
        "wo": tn((d, d), s),
        "w0": torch.full((d,), -4.0, dtype=torch.float32, device=dev),   # decay base
        "w_lora_a": tn((d, LORA_RANK), s),
        "w_lora_b": tn((LORA_RANK, d), LORA_RANK ** -0.5),
        "u": tn((h, dh), 0.3, torch.float32),                           # bonus
        "ln_x_scale": torch.ones((d,), dtype=dtype, device=dev),
        # channel-mix
        "mu_c": 0.5 * torch.ones((2, d), dtype=dtype, device=dev),
        "ck": tn((d, cfg.d_ff), s),
        "cv": tn((cfg.d_ff, d), cfg.d_ff ** -0.5),
        "cr": tn((d, d), s),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} stream of x (B,T,D), zeros before the first token."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor,
                     state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact WKV recurrence (``rwkv6_scan_ref``). r/k/v (B,T,H,K); w
    (B,T,H,K) decay in (0,1); u (H,K).  Returns (out (B,T,H,K) in r's
    dtype, final state (B,H,K,K) fp32)."""
    b, t, h, dk = r.shape
    s = (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
         if state is None else state)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]                # (B,H,K,K)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


def apply_rwkv6_tmix(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Time-mixing over a whole sequence from a zero state: x (B,T,D) -> (B,T,D)."""
    b, t, d = x.shape
    h = cfg.n_heads
    dk = d // h
    prev = _token_shift(x)
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (prev - x) for i in range(5))
    r = (xr @ params["wr"]).reshape(b, t, h, dk)
    k = (xk @ params["wk"]).reshape(b, t, h, dk)
    v = (xv @ params["wv"]).reshape(b, t, h, dk)
    g = F.silu(xg @ params["wg"])
    dec = params["w0"] + (xw @ params["w_lora_a"] @ params["w_lora_b"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, dk)     # data-dependent decay
    out = ops.rwkv6_scan(r, k, v, w, params["u"]).reshape(b, t, d)
    # normalise per head group (the reference's stand-in for RWKV's GroupNorm)
    out = out * torch.rsqrt(torch.mean(out.float() ** 2, -1, keepdim=True)
                            + 1e-5).to(out.dtype)
    out = out * params["ln_x_scale"].to(out.dtype) * g
    return out @ params["wo"]


def apply_rwkv6_cmix(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Channel-mixing over a whole sequence from a zero shift state."""
    prev = _token_shift(x)
    mu = params["mu_c"].to(x.dtype)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    kk = torch.square(torch.relu(xk @ params["ck"]))
    return torch.sigmoid(xr @ params["cr"]) * (kk @ params["cv"])
