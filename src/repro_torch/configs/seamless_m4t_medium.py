"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, audio frontend stubbed.

Backbone only: 12L encoder + 12L decoder, d_model 1024, 16 heads (kv=16),
d_ff 4096, vocab 256206.  The encoder takes precomputed frame embeddings
(B, S, d_model); decode runs against a fixed ``frontend_seq``-frame
encoder memory.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    frontend_seq=4096,
    notes="enc-dec, multimodal; audio frontend stub",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    num_layers=2,
    enc_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="audio",
    frontend_seq=16,
)
