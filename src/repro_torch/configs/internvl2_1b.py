"""internvl2-1b — [vlm] InternViT frontend (stub) + InternLM2/Qwen2-class LM.

24L d_model=896 14H kv=2 d_ff=4864 vocab=151655.  [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    frontend="vision", frontend_seq=1024, qkv_bias=True,
    rope_theta=1e6, act="silu", glu=True, tie_embeddings=True,
    source="[arXiv:2404.16821; hf]",
)
