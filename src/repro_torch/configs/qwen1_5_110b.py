"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family; hf]: dense GQA with QKV bias."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    notes="QKV bias",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen15-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    qkv_bias=True,
)
