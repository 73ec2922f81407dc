"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434; hf]: MLA + MoE.

27L, d_model 2048, 16 heads, MLA kv_lora=512 (+64 rope dim), MoE with
2 shared + 64 routed experts top-6 (expert d_ff 1408); first layer uses a
dense 10944 FFN.  (The assignment line mentions "160 routed" — that is the
full DeepSeek-V2; the Lite header's 64e top-6 is authoritative, see
DESIGN.md §6.)
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_num_shared=2,
    first_layer_dense=True,
    dense_d_ff=10944,
    notes="MLA kv_lora=512, 2 shared + 64 routed top-6",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    use_mla=True,
    kv_lora_rank=32,
    rope_head_dim=8,
    nope_head_dim=16,
    v_head_dim=16,
    moe_num_experts=4,
    moe_top_k=2,
    moe_d_ff=96,
    moe_num_shared=1,
    first_layer_dense=True,
    dense_d_ff=128,
)
