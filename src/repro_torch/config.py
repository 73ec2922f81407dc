"""Model configurations of the port: ``ModelConfig`` and its registry.

A copy of ``repro.config.ModelConfig`` with the same field names and
defaults, so a test can convert the JAX package's config with
``ModelConfig(**dataclasses.asdict(jax_cfg))``.  ``get_arch(name)`` and
``get_smoke_arch(name)`` resolve ``repro_torch.configs.<name>``; the port
carries only the configurations it can run (``configs/``).
``parse_overrides`` reads the launchers' trailing ``key=value`` arguments.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention flavor
    qkv_bias: bool = False
    use_qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_layer_period: int = 1        # every k-th layer is MoE (1 = all)
    moe_capacity_factor: float = 1.25
    first_layer_dense: bool = False  # deepseek: layer 0 uses a dense FFN
    dense_d_ff: int = 0              # width of that dense FFN
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # hybrid (Jamba): one attention layer per `attn_period` layers (rest SSM)
    attn_period: int = 0
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stubs
    frontend: Optional[str] = None   # "audio" | "vision"
    frontend_seq: int = 0            # frames / patches supplied by input_specs
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic archs (DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid")


def _module(name: str):
    key = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_arch(name: str) -> ModelConfig:
    """Resolve an architecture id to its full ModelConfig."""
    return _module(name).CONFIG


def get_smoke_arch(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE_CONFIG


def parse_overrides(args: list[str]) -> dict[str, Any]:
    """Parse trailing ``key=value`` CLI overrides (ints/floats/bools/str)."""
    out: dict[str, Any] = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out
