"""whisper-small — [audio] enc-dec, conv frontend (stub).

12L decoder + 12L encoder, d_model=768, 12H (kv=12), d_ff=3072, vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865,
    n_enc_layers=12, frontend="audio", frontend_seq=1500,
    attention="full", act="gelu", glu=False, tie_embeddings=True,
    source="[arXiv:2212.04356; unverified]",
)
