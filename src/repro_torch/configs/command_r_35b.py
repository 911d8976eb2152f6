"""command-r-35b — [dense] GQA, no-bias, tied embeddings, 256k vocab.

40L d_model=8192 64H kv=8 d_ff=22528 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    rope_theta=4e6, act="silu", glu=True, tie_embeddings=True,
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
)
