"""grok-1-314b — [moe] 8 experts top-2.

64L d_model=6144 48H kv=8 d_ff=32768 vocab=131072.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2,
    rope_theta=1e4, act="gelu", glu=True,
    source="[hf:xai-org/grok-1; unverified]",
)
