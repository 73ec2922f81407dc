"""InternVL2-2B [arXiv:2404.16821; hf]: InternViT (stub) + InternLM2 backbone.

LM backbone: 24L, d_model 2048, 16 heads (kv=8), d_ff 8192, vocab 92553.
``input_specs`` provides precomputed patch embeddings (B, P, d_model).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_seq=256,
    notes="InternViT stub + InternLM2 backbone",
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vision",
    frontend_seq=8,
)
