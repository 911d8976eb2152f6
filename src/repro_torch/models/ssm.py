"""Mamba2 (SSD) block (port of ``repro/models/ssm.py``).

State-space recurrence per head h: for step t
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * (B_t ⊗ x_t)        S: (dh, n)
    y_t = S_t @ C_t + D * x_t
with data-dependent dt (softplus), scalar A per head, depthwise causal conv
on (x, B, C), and a gated RMSNorm output (SiLU(z) gate).

The SSD scan of a whole sequence from the zero state (training and
prefill) goes through ``ops.mamba2_ssd`` (the chunked kernel on the card,
its plain chunked version on the CPU), which also returns the fp32 final
state.  A carried state (``state=``: the conv tail and the ssm state;
decode, one token a step) goes through :func:`mamba2_scan_plain`, the token
recurrence, in PyTorch as the reference's ``lax.scan``; it is also the
oracle the kernel and the chunked version are held to.
:func:`init_mamba2_state` lays out the serving state of every layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rmsnorm, truncated_normal

N_GROUPS = 1  # B/C shared across heads (mamba2 default n_groups=1)


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * N_GROUPS * cfg.ssm_state
    return d_in, nheads, conv_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """One layer's params; ``A_log``, ``D`` and ``dt_bias`` are fp32 at any
    param dtype, as in the reference."""
    d = cfg.d_model
    d_in, nheads, conv_dim = dims(cfg)
    dev = gen.device
    in_dim = 2 * d_in + 2 * N_GROUPS * cfg.ssm_state + nheads  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": truncated_normal((d, in_dim), d ** -0.5, dtype, gen),
        "conv_w": truncated_normal((cfg.ssm_conv, conv_dim), 0.3, dtype, gen),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nheads,), 0.01, **f32))),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": truncated_normal((d_in, d), d_in ** -0.5, dtype, gen),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, nheads, _ = dims(cfg)
    n = N_GROUPS * cfg.ssm_state
    return torch.split(proj, [d_in, d_in + 2 * n, nheads], dim=-1)   # z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along T, then SiLU: xbc (B,T,C), w (K,C);
    ``state`` (B,K-1,C) holds the K-1 inputs before xbc (zeros when None).
    Returns (y, the new tail: the last K-1 inputs, the zero pad included
    where T < K-1).  The reference's shifted sum of products, in the
    compute dtype (``F.conv1d`` in fp32 would go through cuDNN on the card)."""
    k, t = w.shape[0], xbc.shape[1]
    if state is None:
        xp = F.pad(xbc, (0, 0, k - 1, 0))              # (B, T+K-1, C)
    else:
        xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    y = sum(xp[:, i:i + t] * w[i] for i in range(k))
    return F.silu(y + b.to(y.dtype)), xp[:, t:]


def mamba2_scan_plain(x_h: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, D: torch.Tensor,
                      ssm_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact recurrence (``mamba2_scan_ref``).  x_h (B,T,H,P); dt (B,T,H);
    A (H,); B/C (B,T,N); D (H,).  Returns (y (B,T,H,P) in x_h's dtype,
    final state (B,H,P,N) fp32)."""
    bsz, t, h, p = x_h.shape
    n = B.shape[-1]
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x_h.device)
         if ssm_state is None else ssm_state)
    xf, bf, cf = x_h.float(), B.float(), C.float()
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * A)[..., None, None]                        # (B,H,1,1)
        upd = (dt[:, i, :, None] * xf[:, i])[..., None] * bf[:, i, None, None, :]
        s = decay * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, cf[:, i]))
    y = torch.stack(ys, dim=1) + D[None, None, :, None] * xf
    return y.to(x_h.dtype), s


def apply_mamba2(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x (B,T,D) -> (out (B,T,D), the state after x: {"conv" (B,K-1,C),
    "ssm" (B,H,P,N) fp32}).

    Without ``state`` x starts from the zero state (training, prefill) and
    the scan is ``ops.mamba2_ssd``, whose final state carries no gradient;
    with ``state`` (decode) the token recurrence carries it, and the new
    conv tail takes ``state["conv"]``'s dtype."""
    d_in, nheads, _ = dims(cfg)
    n = N_GROUPS * cfg.ssm_state
    bsz, t = x.shape[:2]
    z, xbc, dt = _split_proj(cfg, x @ params["in_proj"])
    xbc, tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                             None if state is None else state["conv"])
    xh, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    xh = xh.reshape(bsz, t, nheads, cfg.ssm_headdim)
    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt.float() + params["dt_bias"])
    if state is None:
        y, S = ops.mamba2_ssd(xh, dt, A, B, C, params["D"])
    else:
        y, S = mamba2_scan_plain(xh, dt, A, B, C, params["D"], state["ssm"])
        tail = tail.to(state["conv"].dtype)
    y = y.reshape(bsz, t, d_in)
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z.to(y.dtype)))
    return y @ params["out_proj"], {"conv": tail, "ssm": S}


def init_mamba2_state(cfg: ModelConfig, batch: int, n_layers: int, dtype: torch.dtype,
                      device) -> dict:
    """Zeroed serving state of ``n_layers`` layers: the conv tail in
    ``dtype``, the ssm state in fp32."""
    _, nheads, conv_dim = dims(cfg)
    return {"conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((n_layers, batch, nheads, cfg.ssm_headdim, cfg.ssm_state),
                               dtype=torch.float32, device=device)}
