"""Granite-8B code model [arXiv:2405.04324; hf]: llama-arch dense GQA."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    notes="llama-arch, code",
)

SMOKE_CONFIG = ModelConfig(
    name="granite8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
