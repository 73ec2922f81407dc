"""Mamba2-370M [arXiv:2405.21060; unverified]: pure SSM (SSD), attention-free."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    notes="SSD (state-space duality); attention-free",
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_chunk=16,
)
