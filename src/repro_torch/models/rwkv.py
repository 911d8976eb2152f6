"""RWKV-6 (Finch) block (port of ``repro/models/rwkv.py``).

Time-mixing per head (K = V = head_dim):
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + LoRA(x~_t))) the data-dependent decay and
token-shift interpolation x~ = lerp(x_t, x_{t-1}, mu); channel-mixing is
the squared-relu RWKV FFN.  The reference's simplifications are kept
(static mu per projection, decay LoRA rank 64).

The WKV recurrence of a whole sequence from the zero state (training and
prefill) goes through ``ops.rwkv6_scan`` (the chunked kernel on the card,
its plain chunked version on the CPU).  Both return the outputs only, so a
prefill forms the final state with :func:`rwkv6_final_state`, one
decay-weighted product outside the kernel.  A carried state (``state=``,
decode: one token a step) goes through :func:`rwkv6_scan_plain`, the token
recurrence, in PyTorch as the reference's ``lax.scan``; it is also the
oracle the kernel and the chunked version are held to.
:func:`init_rwkv6_state` lays out the serving state of every layer.
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


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the x_{t-1} stream of x (B,T,D), x's last token (B,D)): ``last``
    (B,D), the token before x, leads the stream (zeros when None)."""
    head = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([head, x[:, :-1]], dim=1), x[:, -1]


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


def rwkv6_final_state(k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """The state after k/v (B,T,H,K) from the zero state, fp32 (B,H,K,K):
    ``S_T = sum_t diag(prod_{s>t} w_s) k_t v_t^T``.  The exponent of each
    term is the suffix sum of ``log_w`` (fp32 log-decay, <= 0) over s > t,
    summed from the end, so a term near T keeps its digits under strong
    decay (a difference of two long prefix sums would lose them) and a far
    one underflows to 0.  The sums run along the innermost axis, (B,H,K,T):
    along T of (B,T,H,K) the card's scan walks each column in one thread."""
    lw = log_w.permute(0, 2, 3, 1)
    after = torch.cat([lw[..., 1:], torch.zeros_like(lw[..., :1])], dim=-1)
    suffix = torch.flip(torch.cumsum(torch.flip(after, [-1]), dim=-1), [-1])
    return torch.einsum("bthk,bthv->bhkv", torch.exp(suffix).permute(0, 3, 1, 2) * k.float(),
                        v.float())


def apply_rwkv6_tmix(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Optional[dict] = None, *,
                     keep_state: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """Time-mixing: x (B,T,D) -> (out (B,T,D), new_state or None).

    Without ``state`` x starts from the zero state and the scan is
    ``ops.rwkv6_scan``; with ``keep_state`` (prefill) new_state is the
    state after x, ``{"S": rwkv6_final_state(...), "last": x[:, -1]}``,
    else None (training).  With ``state`` ({"S" (B,H,K,K) fp32, "last"
    (B,D)}; decode) the token recurrence carries it and new_state is
    returned."""
    b, t, d = x.shape
    h = cfg.n_heads
    dk = d // h
    prev, new_last = _token_shift(x, None if state is None else state["last"])
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (prev - x) for i in range(5))
    r = (xr @ params["wr"]).reshape(b, t, h, dk)
    k = (xk @ params["wk"]).reshape(b, t, h, dk)
    v = (xv @ params["wv"]).reshape(b, t, h, dk)
    g = F.silu(xg @ params["wg"])
    dec = params["w0"] + (xw @ params["w_lora_a"] @ params["w_lora_b"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(b, t, h, dk)     # data-dependent decay
    new_state = None
    if state is not None:
        out, S = rwkv6_scan_plain(r, k, v, w, params["u"], state["S"])
        new_state = {"S": S, "last": new_last}
    else:
        out = ops.rwkv6_scan(r, k, v, w, params["u"])
        if keep_state:          # the kernel's log-decay, ops.rwkv6_scan's formula
            log_w = torch.log(torch.clamp(w.float(), min=1e-38))
            new_state = {"S": rwkv6_final_state(k, v, log_w), "last": new_last}
    out = out.reshape(b, t, d)
    # normalise per head group (the reference's stand-in for RWKV's GroupNorm)
    out = out * torch.rsqrt(torch.mean(out.float() ** 2, -1, keepdim=True)
                            + 1e-5).to(out.dtype)
    out = out * params["ln_x_scale"].to(out.dtype) * g
    return out @ params["wo"], new_state


def apply_rwkv6_cmix(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-mixing: x (B,T,D) -> (out (B,T,D), new_last_c (B,D): x's last
    token, the shift state after x).  ``state`` ({"last_c" (B,D)}) is the
    token before x; without it the shift starts from zeros."""
    prev, new_last = _token_shift(x, None if state is None else state["last_c"])
    mu = params["mu_c"].to(x.dtype)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    kk = torch.square(torch.relu(xk @ params["ck"]))
    return torch.sigmoid(xr @ params["cr"]) * (kk @ params["cv"]), new_last


def init_rwkv6_state(cfg: ModelConfig, batch: int, n_layers: int, dtype: torch.dtype,
                     device) -> dict:
    """Zeroed serving state of ``n_layers`` layers: the WKV state ``S`` in
    fp32, the two token-shift states in ``dtype``."""
    d, h = cfg.d_model, cfg.n_heads
    dk = d // h
    return {"S": torch.zeros((n_layers, batch, h, dk, dk), dtype=torch.float32, device=device),
            "last": torch.zeros((n_layers, batch, d), dtype=dtype, device=device),
            "last_c": torch.zeros((n_layers, batch, d), dtype=dtype, device=device)}
