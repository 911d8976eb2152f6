"""zamba2-7b — [hybrid] Mamba2 backbone + shared attention blocks.

81L, d_model=3584, shared attn block 32H (kv=32), d_ff=14336, vocab=32000,
ssm_state=64.  The attention+MLP block is a single SHARED set of weights
applied every ``attn_every`` layers (zamba2's signature trick).
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, attn_every=6,
    act="silu", glu=True, tie_embeddings=True,
    source="[arXiv:2411.15242; unverified]",
)
