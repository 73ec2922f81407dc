"""Phi-3-medium (14B) [arXiv:2404.14219; unverified]: dense RoPE/SwiGLU/GQA."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    notes="RoPE SwiGLU GQA",
)

SMOKE_CONFIG = ModelConfig(
    name="phi3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
)
