"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576,
vocab 65536.  Period-8 blocks: 1 attention + 7 Mamba layers; MoE every other
layer.  We use Mamba2/SSD blocks (state=128, headdim=64, expand=2) — see
DESIGN.md §6 approximations.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    attn_period=8,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    notes="mamba+attn 1:7 interleave, MoE 16e top-2",
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    moe_num_experts=4,
    moe_top_k=2,
    moe_d_ff=128,
    moe_layer_period=2,
    attn_period=4,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_chunk=16,
)
