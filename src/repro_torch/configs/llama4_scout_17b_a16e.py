"""llama4-scout-17b-a16e — [moe] 16 experts top-1 + shared expert, early fusion.

48L d_model=5120 40H kv=8 d_ff=8192 vocab=202048.  Long context via
chunked-local (iRoPE-style) attention, window 8192 — this is what makes the
``long_500k`` cell sub-quadratic (see DESIGN.md §4).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, n_shared_experts=1,
    attention="chunked_local", chunk_size=8192,
    rope_theta=5e5, act="silu", glu=True,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
