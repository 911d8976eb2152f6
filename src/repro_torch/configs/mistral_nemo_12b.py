"""mistral-nemo-12b — [dense] 128k-context GQA transformer.

40L, d_model=5120, 32H of head_dim 128 (q_dim 4096), kv=8, d_ff=14336,
vocab=131072.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6, act="silu", glu=True,
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
)
