"""Qwen3-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]: MoE 128e top-8."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    use_qk_norm=True,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    notes="128 experts top-8, QK-Norm",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    use_qk_norm=True,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=96,
)
