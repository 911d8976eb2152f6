"""Analytic FLOP model per (arch x shape x strategy): the roofline's compute
term (port of ``repro/analysis/analytic.py``, the same formulas).

The closed form is exact for the matmul terms (the bulk of the compute):
projections, attention scores over the span each query sees (half the
pairs when causal), the active experts and router of an MoE layer, the WKV6
and SSD inner products, and the head over the padded vocabulary.  A train
step counts forward + backward (3x) and remat's recomputed forward (1x);
pad layers of a pipeline scale the layer work.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import pad_vocab


def _attn_layer_flops(cfg: ModelConfig, tokens: float, seq: int,
                      causal: bool = True) -> float:
    proj = 2.0 * tokens * cfg.attn_params()
    span = min(seq, cfg.chunk_size) if cfg.attention == "chunked_local" else seq
    pair_frac = 0.5 if causal else 1.0
    scores = 4.0 * tokens * span * pair_frac * cfg.n_heads * cfg.head_dim
    return proj + scores


def _mlp_layer_flops(cfg: ModelConfig, tokens: float) -> float:
    if cfg.n_experts:
        mats = 3 if cfg.glu else 2
        active = (cfg.top_k + cfg.n_shared_experts) * mats * cfg.d_model * cfg.d_ff
        router = cfg.d_model * cfg.n_experts
        return 2.0 * tokens * (active + router)
    return 2.0 * tokens * cfg.mlp_params()


def _rwkv_layer_flops(cfg: ModelConfig, tokens: float) -> float:
    k = cfg.d_model // cfg.n_heads
    wkv = 6.0 * tokens * cfg.n_heads * k * k           # out+state+intra
    return 2.0 * tokens * cfg.layer_params() + wkv


def _mamba_layer_flops(cfg: ModelConfig, tokens: float) -> float:
    from repro_torch.models.ssm import dims
    d_in, nheads, _ = dims(cfg)
    c = 64
    ssd = tokens * nheads * (2 * c * cfg.ssm_state + 2 * c * cfg.ssm_headdim
                             + 4 * cfg.ssm_headdim * cfg.ssm_state)
    return 2.0 * tokens * cfg.layer_params() + ssd


def fwd_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global forward FLOPs of one step of this cell."""
    b = shape.global_batch
    if shape.kind == "decode":
        tokens = float(b)
        span = min(shape.seq_len, cfg.chunk_size) \
            if cfg.attention == "chunked_local" else shape.seq_len
        total = 0.0
        if cfg.rwkv:
            total += cfg.n_layers * _rwkv_layer_flops(cfg, tokens)
        elif cfg.family in ("ssm", "hybrid"):
            total += cfg.n_layers * _mamba_layer_flops(cfg, tokens)
            if cfg.attn_every:
                n_attn = -(-cfg.n_layers // cfg.attn_every)
                total += n_attn * (2 * tokens * (cfg.attn_params()
                                                 + cfg.mlp_params())
                                   + 4 * tokens * span * cfg.n_heads
                                   * cfg.head_dim)
        else:
            per = (2 * tokens * cfg.attn_params()
                   + 4 * tokens * span * cfg.n_heads * cfg.head_dim)
            per += _mlp_layer_flops(cfg, tokens)
            total += cfg.n_layers * per
            if cfg.n_enc_layers:            # whisper cross-attn reads
                total += cfg.n_layers * (2 * tokens * cfg.attn_params()
                                         + 4 * tokens * cfg.frontend_seq
                                         * cfg.n_heads * cfg.head_dim)
        total += 2.0 * tokens * cfg.d_model * pad_vocab(cfg.vocab_size)
        return total

    # train / prefill: full sequences
    tokens = float(shape.tokens_per_step)
    seq = shape.seq_len
    total = 0.0
    if cfg.rwkv:
        total = cfg.n_layers * _rwkv_layer_flops(cfg, tokens)
    elif cfg.family in ("ssm", "hybrid"):
        total = cfg.n_layers * _mamba_layer_flops(cfg, tokens)
        if cfg.attn_every:
            n_attn = -(-cfg.n_layers // cfg.attn_every)
            total += n_attn * (_attn_layer_flops(cfg, tokens, seq)
                               + 2 * tokens * cfg.mlp_params())
    elif cfg.n_enc_layers:                  # whisper enc-dec
        enc_tokens = float(b * cfg.frontend_seq)
        total += cfg.n_enc_layers * (
            _attn_layer_flops(cfg, enc_tokens, cfg.frontend_seq, causal=False)
            + 2 * enc_tokens * cfg.mlp_params())
        total += cfg.n_layers * (
            _attn_layer_flops(cfg, tokens, seq)
            + 2 * tokens * cfg.attn_params()                 # cross proj
            + 4 * tokens * cfg.frontend_seq * cfg.n_heads * cfg.head_dim
            + 2 * tokens * cfg.mlp_params())
    else:
        total = cfg.n_layers * (_attn_layer_flops(cfg, tokens, seq)
                                + _mlp_layer_flops(cfg, tokens))
    # head/CE: every position for train, last token for prefill
    ce_tokens = tokens if shape.kind == "train" else float(b)
    total += 2.0 * ce_tokens * cfg.d_model * pad_vocab(cfg.vocab_size)
    return total


def step_flops(cfg: ModelConfig, shape: ShapeConfig, remat: bool = True,
               pad_layers: int = 0) -> float:
    """Global FLOPs of one step (train: fwd+bwd (3x) + remat re-fwd (1x))."""
    f = fwd_flops(cfg, shape)
    if shape.kind == "train":
        f *= 4.0 if remat else 3.0
    if pad_layers:
        f *= 1.0 + pad_layers / cfg.n_layers
    return f


def flops_per_device(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                     remat: bool = True, pad_layers: int = 0) -> float:
    return step_flops(cfg, shape, remat, pad_layers) / chips
