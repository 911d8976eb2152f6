"""rwkv6-1.6b (Finch) — [ssm] attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536.  [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    rwkv=True, act="silu", glu=False,
    source="[arXiv:2404.05892; unverified]",
)
