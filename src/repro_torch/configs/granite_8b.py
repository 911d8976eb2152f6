"""granite-8b — [dense] llama-arch, code.  36L d_model=4096 32H kv=8
d_ff=14336 vocab=49152.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152,
    rope_theta=1e7, act="silu", glu=True, tie_embeddings=True,
    source="[arXiv:2405.04324; hf]",
)
