"""Plain reference of the RWKV-6 ("Finch") language model as the port's
configuration runs it, for training: pre-norm blocks of time mixing (token
shift by static mixes, data-dependent decay w = exp(-exp(w0 + x A B)), the
WKV recurrence with bonus u, a normalisation over the whole width, a SiLU
gate) and channel mixing (squared-ReLU key, sigmoid receptance), then a
final RMSNorm, an untied head and the mean next-token cross-entropy.

Departures from the published model, as the configuration states them:
static token-shift mixes (no data-dependent lerp), a decay LoRA of rank 64,
an RMS normalisation over the width in place of the per-head GroupNorm,
random weights from the seed.

The WKV recurrence
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
is computed exactly in chunks of 16 tokens: within a chunk every pair's
decay is the exponential of a difference of log-decay sums (never above 0),
between chunks the state is carried.  fp32 throughout, TF32 off; every
layer is recomputed in the backward (activation checkpointing), so a step
fits beside the optimizer state.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import AdamW, Path, Spec, exact_fp32, linear, padded_vocab, rms

LORA = 64
CHUNK = 16


def param_specs(m: Dict) -> List[Spec]:
    d, h, f = m["d_model"], m["n_heads"], m["d_ff"]
    dh, bf, f32 = d // h, "bfloat16", "float32"
    vp = padded_vocab(m["vocab_size"])
    specs: List[Spec] = [(("embed", "tok"), (vp, d), bf, "normal", 1.0)]
    for i in range(m["n_layers"]):
        b, r = ("blocks", i), ("blocks", i, "rwkv")
        specs += [
            (b + ("ln1", "scale"), (d,), bf, "const", 1.0),
            (b + ("ln2", "scale"), (d,), bf, "const", 1.0),
            (r + ("mu",), (5, d), bf, "const", 0.5),
            (r + ("wr",), (d, d), bf, "normal", d ** -0.5),
            (r + ("wk",), (d, d), bf, "normal", d ** -0.5),
            (r + ("wv",), (d, d), bf, "normal", d ** -0.5),
            (r + ("wg",), (d, d), bf, "normal", d ** -0.5),
            (r + ("wo",), (d, d), bf, "normal", d ** -0.5),
            (r + ("w0",), (d,), f32, "const", -4.0),
            (r + ("w_lora_a",), (d, LORA), bf, "normal", d ** -0.5),
            (r + ("w_lora_b",), (LORA, d), bf, "normal", LORA ** -0.5),
            (r + ("u",), (h, dh), f32, "normal", 0.3),
            (r + ("ln_x_scale",), (d,), bf, "const", 1.0),
            (r + ("mu_c",), (2, d), bf, "const", 0.5),
            (r + ("ck",), (d, f), bf, "normal", d ** -0.5),
            (r + ("cv",), (f, d), bf, "normal", f ** -0.5),
            (r + ("cr",), (d, d), bf, "normal", d ** -0.5),
        ]
    specs += [(("final_ln", "scale"), (d,), bf, "const", 1.0),
              (("head", "w"), (d, vp), bf, "normal", d ** -0.5)]
    return specs


def wkv(r, k, v, logw, u):
    """The WKV recurrence from the zero state: r, k, v, logw (B, T, H, K)
    fp32 (logw = log w <= 0), u (H, K); returns (B, T, H, K)."""
    b, t, h, dk = r.shape
    pad = -t % CHUNK
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = z(r), z(k), z(v), z(logw)
    n = (t + pad) // CHUNK
    split = lambda a: a.reshape(b, n, CHUNK, h, dk).permute(0, 3, 1, 2, 4)   # (B,H,N,C,K)
    r_, k_, v_, lw = split(r), split(k), split(v), split(logw)
    c = torch.cumsum(lw, dim=3)                        # through token s
    cp = c - lw                                        # before token t
    later = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device), -1)
    expo = (cp[..., :, None, :] - c[..., None, :, :]).masked_fill(~later[..., None], float("-inf"))
    scores = (r_[..., :, None, :] * torch.exp(expo) * k_[..., None, :, :]).sum(-1)
    bonus = (r_ * u[None, :, None, None, :] * k_).sum(-1, keepdim=True)
    out = scores @ v_ + bonus * v_
    k_end = k_ * torch.exp(c[..., -1:, :] - c)         # decay from s to the chunk's end
    r_start = r_ * torch.exp(cp)                       # decay from the chunk's start to t
    end = torch.exp(c[..., -1, :])                     # (B,H,N,K)
    state = torch.zeros(b, h, dk, dk, dtype=r.dtype, device=r.device)
    inter = []
    for i in range(n):
        inter.append(r_start[:, :, i] @ state)
        state = end[:, :, i, :, None] * state + k_end[:, :, i].transpose(-1, -2) @ v_[:, :, i]
    out = out + torch.stack(inter, dim=2)
    return out.permute(0, 2, 3, 1, 4).reshape(b, n * CHUNK, h, dk)[:, :t]


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _block(m: Dict, fp8: bool, x, ln1, ln2, mu, wr, wk, wv, wg, wo, w0, wa, wb, u, lnx,
           mu_c, ck, cv, cr):
    eps, h = m["norm_eps"], m["n_heads"]
    b, t, d = x.shape
    a = rms(x, ln1, eps)
    prev = _shift(a)
    xr, xk, xv, xw, xg = (a + mu[i] * (prev - a) for i in range(5))
    lin = lambda y, w: linear(y.reshape(-1, y.shape[-1]), w, fp8).view(b, t, -1)
    r = lin(xr, wr).view(b, t, h, -1)
    k = lin(xk, wk).view(b, t, h, -1)
    v = lin(xv, wv).view(b, t, h, -1)
    g = F.silu(lin(xg, wg))
    logw = -torch.exp(w0 + lin(lin(xw, wa), wb)).view(b, t, h, -1)
    y = wkv(r, k, v, logw, u).reshape(b, t, d)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5) * lnx * g
    x = x + lin(y, wo)
    a = rms(x, ln2, eps)
    prev = _shift(a)
    xk, xr = a + mu_c[0] * (prev - a), a + mu_c[1] * (prev - a)
    return x + torch.sigmoid(lin(xr, cr)) * lin(torch.square(torch.relu(lin(xk, ck))), cv)


NAMES = ("mu", "wr", "wk", "wv", "wg", "wo", "w0", "w_lora_a", "w_lora_b", "u", "ln_x_scale",
         "mu_c", "ck", "cv", "cr")


def loss(m: Dict, p: Dict[Path, torch.Tensor], tokens: torch.Tensor, fp8: bool = False):
    """Mean next-token cross-entropy of tokens (B, T) under the fp32 leaves
    ``p`` (paths as in :func:`param_specs`)."""
    x = p[("embed", "tok")][tokens.long()]
    for i in range(m["n_layers"]):
        leaves = [p[("blocks", i, "ln1", "scale")], p[("blocks", i, "ln2", "scale")]]
        leaves += [p[("blocks", i, "rwkv", n)] for n in NAMES]
        x = checkpoint(_block, m, fp8, x, *leaves, use_reentrant=False)
    hid = rms(x, p[("final_ln", "scale")], m["norm_eps"])[:, :-1]
    labels = tokens[:, 1:].long()
    w = p[("head", "w")][:, :m["vocab_size"]]
    total = 0.0
    for lo in range(0, hid.shape[1], 256):
        def ce(hh, ww, ll):
            lg = linear(hh.reshape(-1, hh.shape[-1]), ww, fp8)
            return F.cross_entropy(lg, ll.reshape(-1), reduction="sum")
        total = total + checkpoint(ce, hid[:, lo:lo + 256], w, labels[:, lo:lo + 256],
                                   use_reentrant=False)
    return total / labels.numel()


def train(m: Dict, opt: Dict, params: Dict[Path, torch.Tensor],
          batches: Sequence[torch.Tensor], fp8: bool = False) -> Dict:
    """Steps of the configuration's AdamW from ``params`` (stored in their
    dtype, updated in place, so they hold the parameters after the last
    step) over ``batches``: each step's loss and the norm of every leaf's
    clipped gradient in the first step."""
    adam = AdamW(opt, params)
    losses: List[float] = []
    first = None
    with exact_fp32():
        for tokens in batches:
            p32 = {k: t.float().requires_grad_(True) for k, t in params.items()}
            value = loss(m, p32, tokens, fp8)
            keys = list(p32)
            grads = torch.autograd.grad(value, [p32[k] for k in keys])
            losses.append(float(value.detach()))
            del p32, value
            clipped = adam.update(params, dict(zip(keys, grads)))
            del grads
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g)) for k, g in clipped.items()}
            del clipped
    return {"losses": losses, "grad_norms": first}
