"""Architecture registry of the PyTorch port: ``--arch <id>`` resolution and
reduced smoke configs.

The model configs are copies of ``repro.configs`` (the port imports nothing
from the JAX package), registered in the reference's order, so ``ARCH_IDS``
is the reference's; ``reduced_config`` is the reference's, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    LONG_500K,
    DECODE_32K,
    PREFILL_32K,
    TRAIN_4K,
    SHAPES,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    shape_applicable,
)

from repro_torch.configs import (  # noqa: E402
    command_r_35b,
    granite_8b,
    grok1_314b,
    internvl2_1b,
    llama4_scout_17b_a16e,
    mistral_nemo_12b,
    rwkv6_1p6b,
    whisper_small,
    yi_34b,
    zamba2_7b,
)

_MODULES = (
    whisper_small, zamba2_7b, mistral_nemo_12b, yi_34b, granite_8b,
    command_r_35b, llama4_scout_17b_a16e, grok1_314b, rwkv6_1p6b, internvl2_1b,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}

ARCH_IDS: List[str] = list(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-sized variant of the same family (CPU-runnable).

    Keeps every structural feature (GQA ratio, MoE, hybrid pattern, frontends,
    enc-dec) while shrinking width/depth/vocab.
    """
    kw = dataclasses.asdict(cfg)
    gqa_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    kw.update(
        arch_id=cfg.arch_id + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, 4 // gqa_ratio),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2))
    if cfg.family in ("ssm", "hybrid") and not cfg.rwkv:
        kw.update(ssm_state=16, ssm_headdim=32,
                  attn_every=2 if cfg.attn_every else 0)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2)
    if cfg.frontend:
        kw.update(frontend_seq=16)
    if cfg.attention == "chunked_local":
        kw.update(chunk_size=32)
    return ModelConfig(**kw)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=64, global_batch=2, kind="train")
