"""Encoder-decoder LM, whisper-small (port of ``repro/models/encdec.py``).

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, D).  Both stacks add sinusoidal
positions and use no RoPE; the encoder's self-attention is unmasked, the
decoder's causal, and each decoder layer cross-attends to the encoder's
rows.  The head is the embedding table itself (``x @ tok.T``, no
``d_model**-0.5`` scale, unlike ``lm.head_logits``).

Params::

    {"embed": {"tok": (Vp, D)},
     "enc_blocks": [one dict per encoder layer], "enc_ln": {"scale": (D,)},
     "dec_blocks": [one dict per decoder layer], "final_ln": {"scale": (D,)}}

Cache (decode), the reference's tree::

    {"layers": {"k": (L, B, max_len, KVH, Dh), "v": ...,
                "xk": (L, B, n_frames, KVH, Dh), "xv": ...}, "pos": (B,) int32}

``xk``/``xv`` are the encoder rows' cross K/V, computed once at prefill.
Every attention goes through ``kernels/ops.py``: the encoder and the cross
attention of a prompt through the flash kernel (non-causal, the cross one at
Tk = n_frames), decode self-attention through the dense decode kernel, and
decode cross-attention through the same kernel with every encoder row
valid.  Decode writes K/V into the cache IN PLACE, as ``lm`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, chunked_xent, embed_tokens, init_embed,
                                       init_mlp, init_rmsnorm, rmsnorm, sinusoidal_positions)
from repro_torch.models.lm import dtype_of

_TABLES: Dict[Tuple[int, torch.dtype, torch.device], torch.Tensor] = {}


def positions_table(n: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`sinusoidal_positions` (n, d) in ``dtype`` on ``device``: the
    first n rows of the longest table made so far for (d, dtype, device)
    (a row depends on its position alone), so decode adds a row a step
    without building one."""
    key = (d, dtype, torch.device(device))
    t = _TABLES.get(key)
    if t is None or t.shape[0] < n:
        t = _TABLES[key] = torch.from_numpy(sinusoidal_positions(n, d)).to(device, dtype)
    return t[:n]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    return {"ln1": init_rmsnorm(d, dtype, gen.device),
            "attn": attn.init_attention(gen, cfg, dtype),
            "ln2": init_rmsnorm(d, dtype, gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.glu, dtype)}


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    return {"ln1": init_rmsnorm(d, dtype, gen.device),
            "attn": attn.init_attention(gen, cfg, dtype),
            "lnx": init_rmsnorm(d, dtype, gen.device),
            "xattn": attn.init_attention(gen, cfg, dtype),
            "ln2": init_rmsnorm(d, dtype, gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.glu, dtype)}


def init_encdec(cfg: ModelConfig, gen: torch.Generator, param_dtype: torch.dtype) -> dict:
    """Random weights drawn in a fixed order from ``gen`` on its device."""
    return {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, param_dtype),
            "enc_blocks": [_init_enc_block(gen, cfg, param_dtype)
                           for _ in range(cfg.n_enc_layers)],
            "enc_ln": init_rmsnorm(cfg.d_model, param_dtype, gen.device),
            "dec_blocks": [_init_dec_block(gen, cfg, param_dtype) for _ in range(cfg.n_layers)],
            "final_ln": init_rmsnorm(cfg.d_model, param_dtype, gen.device)}


def _layers(fn, x: torch.Tensor, blocks: list, rcfg: RunConfig) -> torch.Tensor:
    """``x = fn(bp, x)`` over ``blocks``, each layer checkpointed under
    ``rcfg.remat`` with grad on."""
    remat = rcfg.remat and torch.is_grad_enabled()
    for bp in blocks:
        x = checkpoint(fn, bp, x, use_reentrant=False) if remat else fn(bp, x)
    return x


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           rcfg: RunConfig) -> torch.Tensor:
    """Frames (B, Te, D) -> the encoder's normed rows (B, Te, D)."""
    cdt = dtype_of(rcfg.compute_dtype)
    pos = positions_table(frames.shape[1], cfg.d_model, cdt, frames.device)
    x = frames.to(cdt) + pos[None]

    def body(bp, x):
        x = x + attn.attention(bp["attn"], cfg, rmsnorm(bp["ln1"], x), use_rope=False,
                               causal=False)
        return x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)

    return rmsnorm(params["enc_ln"], _layers(body, x, params["enc_blocks"], rcfg))


# ---------------------------------------------------------------------------
# decoder (train)
# ---------------------------------------------------------------------------

def _dec_block_train(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    x = x + attn.attention(bp["attn"], cfg, rmsnorm(bp["ln1"], x), use_rope=False, causal=True)
    x = x + attn.cross_attention(bp["xattn"], cfg, rmsnorm(bp["lnx"], x), enc_out)
    return x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           cdt: torch.dtype) -> torch.Tensor:
    pos = positions_table(tokens.shape[1], cfg.d_model, cdt, tokens.device)
    return embed_tokens(params["embed"], tokens.long(), cdt) + pos[None]


def encdec_loss(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                rcfg: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of ``batch["tokens"]`` (B, T) given ``batch["frames"]``:
    (loss, {"ce", "aux"}), aux 0."""
    cdt = dtype_of(rcfg.compute_dtype)
    tokens = batch["tokens"].long()
    enc_out = encode(cfg, params, batch["frames"], rcfg)
    x = _embed(cfg, params, tokens, cdt)
    x = _layers(lambda bp, x: _dec_block_train(cfg, bp, x, enc_out), x,
                params["dec_blocks"], rcfg)
    x = rmsnorm(params["final_ln"], x)
    t = tokens.shape[1]
    ce = chunked_xent(x[:, :-1], params["embed"]["tok"].t(), tokens[:, 1:], cfg.vocab_size,
                      chunk=min(2048, t - 1))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


# ---------------------------------------------------------------------------
# prefill / decode (serving)
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                      device, n_frames: int = 0) -> dict:
    """The zeroed decode cache of ``batch`` lanes (the module docstring's
    layout); the cross slots hold ``n_frames`` rows (default the config's
    ``frontend_seq``)."""
    te = n_frames or cfg.frontend_seq
    kv = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim),
                               dtype=dtype, device=device)
    return {"layers": {"k": kv(max_len), "v": kv(max_len), "xk": kv(te), "xv": kv(te)},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def encdec_prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                   rcfg: RunConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """Encode ``batch["frames"]`` and run the prompt ``batch["tokens"]``
    through the decoder: (last-token logits (B, Vp), the cache)."""
    cdt = dtype_of(rcfg.compute_dtype)
    tokens = batch["tokens"].long()
    bsz, t = tokens.shape
    enc_out = encode(cfg, params, batch["frames"], rcfg)
    te = enc_out.shape[1]
    cache = init_encdec_cache(cfg, bsz, max_len, cdt, tokens.device, te)
    layers = cache["layers"]
    x = _embed(cfg, params, tokens, cdt)
    for i, bp in enumerate(params["dec_blocks"]):
        h, ck, cv = attn.prefill_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), None, max_len)
        x = x + h
        x = x + attn.cross_attention(bp["xattn"], cfg, rmsnorm(bp["lnx"], x), enc_out)
        x = x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)
        # cross K/V computed once here for reuse at decode time
        layers["k"][i].copy_(ck)
        layers["v"][i].copy_(cv)
        layers["xk"][i].copy_((enc_out @ bp["xattn"]["wk"]).reshape(
            bsz, te, cfg.n_kv_heads, cfg.head_dim))
        layers["xv"][i].copy_((enc_out @ bp["xattn"]["wv"]).reshape(
            bsz, te, cfg.n_kv_heads, cfg.head_dim))
    x = rmsnorm(params["final_ln"], x)
    cache["pos"].fill_(t)
    return x[:, -1] @ params["embed"]["tok"].t().to(cdt), cache


def encdec_decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                       rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step, tokens (B, 1): (logits (B, Vp), the cache with
    ``pos`` advanced); this token's K/V are written in place."""
    cdt = dtype_of(rcfg.compute_dtype)
    bsz = tokens.shape[0]
    pos = cache["pos"]
    layers = cache["layers"]
    ks, vs, xks, xvs = layers["k"], layers["v"], layers["xk"], layers["xv"]
    span = ks.shape[2]
    table = positions_table(span, cfg.d_model, cdt, tokens.device)
    x = embed_tokens(params["embed"], tokens.long(), cdt)
    x = x + table[torch.clamp(pos, max=span - 1).long()][:, None]
    rows, valid = attn.decode_slots(cfg, pos, span)
    xvalid = torch.ones((bsz, xks.shape[2]), dtype=torch.bool, device=tokens.device)
    scale = cfg.head_dim ** -0.5
    for i, bp in enumerate(params["dec_blocks"]):
        x = x + attn.decode_attn(bp["attn"], cfg, rmsnorm(bp["ln1"], x), ks[i], vs[i], None,
                                 rows, valid)
        # cross attention against the encoder rows' K/V, every row valid
        q = (rmsnorm(bp["lnx"], x) @ bp["xattn"]["wq"]).reshape(bsz, 1, cfg.n_heads,
                                                                 cfg.head_dim)
        h = ops.decode_attention(q, xks[i].to(q.dtype), xvs[i].to(q.dtype), xvalid, scale)
        x = x + h.reshape(bsz, 1, cfg.q_dim) @ bp["xattn"]["wo"]
        x = x + apply_mlp(bp["mlp"], rmsnorm(bp["ln2"], x), cfg.act)
    x = rmsnorm(params["final_ln"], x)
    logits = x[:, -1] @ params["embed"]["tok"].t().to(cdt)
    return logits, {"layers": layers, "pos": pos + 1}


def encdec_decode_window(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor,
                         rcfg: RunConfig) -> Tuple[torch.Tensor, dict]:
    """W sequential decode steps (speculative verify), tokens (B, W): the
    logits after each (B, W, Vp), bitwise those of W single steps."""
    out = []
    for j in range(tokens.shape[1]):
        logits, cache = encdec_decode_step(cfg, params, cache, tokens[:, j:j + 1], rcfg)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def encdec_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       rcfg: RunConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every input of this cell: train/prefill
    ``{"tokens", "frames" (B, frontend_seq, D)}``, decode ``{"tokens" (B, 1),
    "cache"}``."""
    cdt, meta = dtype_of(rcfg.compute_dtype), torch.device("meta")
    bsz = shape.global_batch
    if shape.kind in ("train", "prefill"):
        return {"tokens": torch.empty((bsz, shape.seq_len), dtype=torch.int32, device=meta),
                "frames": torch.empty((bsz, cfg.frontend_seq, cfg.d_model), dtype=cdt,
                                      device=meta)}
    return {"tokens": torch.empty((bsz, 1), dtype=torch.int32, device=meta),
            "cache": init_encdec_cache(cfg, bsz, shape.seq_len, cdt, meta)}
