"""Plain reference of the dense decoder (granite-8b): pre-norm blocks of
grouped-query causal attention with split-halves RoPE and a SwiGLU MLP,
a final RMSNorm, and a head tied to the embedding (hidden states scaled by
d_model ** -0.5 before the product).

fp32 arithmetic over the bf16 weights as they are served, TF32 off, layer
by layer over every sequence so one layer's weights are widened once.  The
control (``fp8=True``) rounds both operands of every matrix product to
float8 e4m3.  Departure from the published model: random weights from the
seed, every norm scale 1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from reference.common import Spec, exact_fp32, linear, padded_vocab, rms


def param_specs(m: Dict) -> List[Spec]:
    d, h, g, dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    bf = "bfloat16"
    # the embedding at 0.02 (the usual init): at N(0, 1) the tied head's
    # logit of the current token dwarfs every other, the greedy output
    # repeats its input, and no precision changes a served token
    specs: List[Spec] = [(("embed", "tok"), (padded_vocab(m["vocab_size"]), d), bf, "normal",
                          0.02)]
    for i in range(m["n_layers"]):
        b = ("blocks", i)
        specs += [
            (b + ("ln1", "scale"), (d,), bf, "const", 1.0),
            (b + ("ln2", "scale"), (d,), bf, "const", 1.0),
            (b + ("attn", "wq"), (d, h * dh), bf, "normal", d ** -0.5),
            (b + ("attn", "wk"), (d, g * dh), bf, "normal", d ** -0.5),
            (b + ("attn", "wv"), (d, g * dh), bf, "normal", d ** -0.5),
            (b + ("attn", "wo"), (h * dh, d), bf, "normal", (h * dh) ** -0.5),
            (b + ("mlp", "wi"), (d, f), bf, "normal", d ** -0.5),
            (b + ("mlp", "wg"), (d, f), bf, "normal", d ** -0.5),
            (b + ("mlp", "wo"), (f, d), bf, "normal", f ** -0.5),
        ]
    specs.append((("final_ln", "scale"), (d,), bf, "const", 1.0))
    return specs


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves rotation of x (T, heads, Dh) at positions 0..T-1; the
    angles in float64."""
    t, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), causal) v for q (T, H, Dh), k and v (T, G,
    Dh); query head i reads key/value head i // (H / G)."""
    t, h, dh = q.shape
    rep = h // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = torch.empty_like(qh)
    for q0 in range(0, t, block):
        q1 = min(t, q0 + block)
        s = qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2) * dh ** -0.5
        keys = torch.arange(q1, device=q.device)
        keep = keys[None, :] <= torch.arange(q0, q1, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        out[:, q0:q1] = torch.softmax(s, dim=-1) @ vh[:, :q1]
    return out.transpose(0, 1).reshape(t, h * dh)


@torch.no_grad()
def logits_at(m: Dict, params: dict, seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], fp8: bool = False) -> List[torch.Tensor]:
    """Next-token logits (n_i, vocab) fp32 of each token sequence ``seqs[i]``
    (T_i,) at the positions ``positions[i]`` (n_i,), by one causal forward
    pass over the whole sequence."""
    eps, h, g, dh = m["norm_eps"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    emb = params["embed"]["tok"]
    with exact_fp32():
        xs = [emb[s.long()].float() for s in seqs]
        for bp in params["blocks"]:
            w = {k: t.float() for part in ("attn", "mlp") for k, t in
                 ((f"{part}.{n}", x) for n, x in bp[part].items())}
            ln1, ln2 = bp["ln1"]["scale"].float(), bp["ln2"]["scale"].float()
            for i, x in enumerate(xs):
                t = x.shape[0]
                a = rms(x, ln1, eps)
                q = _rope(linear(a, w["attn.wq"], fp8).view(t, h, dh), m["rope_theta"])
                k = _rope(linear(a, w["attn.wk"], fp8).view(t, g, dh), m["rope_theta"])
                v = linear(a, w["attn.wv"], fp8).view(t, g, dh)
                x = x + linear(_causal_attention(q, k, v), w["attn.wo"], fp8)
                a = rms(x, ln2, eps)
                gate = torch.nn.functional.silu(linear(a, w["mlp.wg"], fp8))
                xs[i] = x + linear(gate * linear(a, w["mlp.wi"], fp8), w["mlp.wo"], fp8)
            del w
        fin = params["final_ln"]["scale"].float()
        head = emb.float().t()
        out = []
        for x, pos in zip(xs, positions):
            hid = rms(x[pos.long()], fin, eps) * m["d_model"] ** -0.5
            out.append(linear(hid, head, fp8)[:, :m["vocab_size"]])
        return out
