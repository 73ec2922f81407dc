"""Granite-3.0-8B [hf:ibm-granite/granite-3.0-2b-base family; hf]: dense GQA."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    notes="GQA",
)

SMOKE_CONFIG = ModelConfig(
    name="granite3-smoke",
    family="dense",
    num_layers=3,
    d_model=48,
    num_heads=4,
    num_kv_heads=2,
    head_dim=12,
    d_ff=96,
    vocab_size=251,  # deliberately non-round, like the full config's 49155
)
