"""Three-term roofline model per (arch x shape x mesh) cell, with the
constants of one NVIDIA H100 SXM5 (port of ``repro.analysis.roofline``).

Terms (seconds per step, per device):

  compute    = dot_FLOPs_per_device / peak_FLOP/s        (989.4 TF/s bf16)
  memory     = analytical_bytes_per_device / HBM_bw      (3.35 TB/s)
  collective = collective_bytes_per_device / link_bw     (450 GB/s NVLink)

FLOPs and collective bytes come from ``analysis.op_costs.step_costs``,
counted on a rank's local tensors as the step runs (JAX's come from the
loop-corrected HLO parse).  Memory bytes are analytical (weights /
optimizer / KV / activation traffic), the same closed forms as JAX's.

``HW`` keeps JAX's three keys, so ``roofline_row`` reads as JAX's does:

* ``peak_flops``: 989.4e12 FLOP/s, the dense bfloat16 tensor-core peak of
  the H100 SXM5 without sparsity (NVIDIA H100 Tensor Core GPU datasheet);
* ``hbm_bw``: 3.35e12 B/s, its HBM3 bandwidth (same datasheet);
* ``ici_bw``: 450e9 B/s, what the collective term divides by.  On the TPU
  it was one ICI link; here it is one GPU's NVLink 4 bandwidth in one
  direction: 18 links of 25 GB/s each way (900 GB/s both ways, same
  datasheet), which a collective over the NVSwitch uses together.
  ``NVLINK_LINK_BW`` is one link's 25e9 B/s each way.

The datasheet's rates assume the card's full 700 W; a card capped below
it runs slower, so a measured share is stated beside its power limit.

MODEL_FLOPS: 6*N*D for training (N = active params, D = tokens), 2*N*D for
forward-only shapes.  MODEL_FLOPS / dot_FLOPs(global) measures how much of
the counted compute is useful (remat + dispatch waste).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import param_count

HW = {
    "peak_flops": 989.4e12,   # bf16 dense tensor-core FLOP/s, H100 SXM5
    "hbm_bw": 3.35e12,        # HBM3 B/s
    "ici_bw": 450e9,          # NVLink 4 B/s per GPU, one direction
}
NVLINK_LINK_BW = 25e9         # one NVLink 4 link, one direction


# ---------------------------------------------------------------------------
# Parameter accounting
# ---------------------------------------------------------------------------

def _moe_layers(cfg: ModelConfig) -> int:
    if cfg.moe_num_experts == 0:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.moe_layer_period
    n = cfg.num_layers
    if cfg.first_layer_dense:
        n -= 1
    return n


def active_params(cfg: ModelConfig) -> tuple[float, float]:
    """(N_total, N_active): active removes the un-routed experts."""
    n_total = float(param_count(model_param_defs(cfg)))
    n_moe = _moe_layers(cfg)
    if n_moe == 0:
        return n_total, n_total
    per_expert = 3.0 * cfg.d_model * cfg.moe_d_ff
    inactive = n_moe * (cfg.moe_num_experts - cfg.moe_top_k) * per_expert
    return n_total, n_total - inactive


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    if cfg.family == "encdec":
        return cfg.num_layers + cfg.enc_layers + cfg.num_layers  # self+self+cross
    return cfg.num_layers


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (fwd-only)."""
    _, n_act = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # decode: one token per sequence


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, kv_int8: bool = False) -> float:
    """Global KV/state cache bytes for decode shapes."""
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    hd = cfg.resolved_head_dim
    kv_elt = (1 + 1 / max(hd, 1) * 4) if kv_int8 else 2  # int8 + f32 scale/row
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        if cfg.use_mla:
            total += cfg.num_layers * b * s * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
        else:
            total += _attn_layers(cfg) * b * s * cfg.num_kv_heads * hd * kv_elt * 2
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_period
        total += n_attn * b * s * cfg.num_kv_heads * hd * 2 * 2
        n_ssm = cfg.num_layers - n_attn
        total += n_ssm * b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
    if cfg.family == "ssm":
        total += cfg.num_layers * b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
    return total


def memory_bytes_per_device(
    cfg: ModelConfig, shape: ShapeConfig, n_dev: int, microbatches: int = 8,
    kv_int8: bool = False,
) -> float:
    """Analytical per-device HBM traffic for one step (JAX's formulas).

    train:  weights read fwd+bwd per microbatch (4·mb·N bf16-bytes ≈ 2B each),
            grads fp32 write+read, AdamW m/v read+write, param update write,
            activation traffic ~16 bytes per token-dim per layer.
    prefill: weights once + activations + KV write.
    decode:  weights once (2·N_active) + full KV read + tiny writes.
    """
    n_tot, n_act = active_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    L = cfg.num_layers + cfg.enc_layers
    d = cfg.d_model
    if shape.kind == "train":
        tokens = b * s
        weights = 4.0 * microbatches * n_act * 2.0  # read fwd+bwd per microbatch
        opt = (4 + 4 + 16 + 2) * n_tot              # grads w/r, m+v rw, param w
        acts = 16.0 * tokens * d * L / max(1, 1)    # bf16 reads+writes, flash attn
        return (weights + opt + acts) / n_dev
    if shape.kind == "prefill":
        tokens = b * s
        weights = 2.0 * n_act
        acts = 8.0 * tokens * d * L
        kv = kv_cache_bytes(cfg, shape)
        return (weights + acts + kv) / n_dev
    # decode
    weights = 2.0 * n_act
    kv = kv_cache_bytes(cfg, shape, kv_int8)
    acts = 8.0 * b * d * L
    return (weights + kv + acts) / n_dev


# ---------------------------------------------------------------------------
# Roofline row
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineRow:
    cell: str
    n_dev: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    fix_hint: str

    def as_dict(self):
        return dataclasses.asdict(self)


_FIX_HINTS = {
    "compute": "increase per-chip arithmetic intensity: larger microbatch, "
               "fuse small einsums, reduce remat recompute",
    "memory": "cut HBM traffic: fewer weight re-reads (larger microbatch), "
              "quantize KV pages (int8), latent/MLA caching",
    "collective": "reshard to cut cross-chip bytes: move TP axis off the hot "
                  "dim, overlap grad all-reduce with backward, gossip subsample",
}


def roofline_row(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_dev: int,
    hlo_costs: dict,
    microbatches: int = 8,
    cell: Optional[str] = None,
    kv_int8: bool = False,
) -> RooflineRow:
    """The three terms of one cell; ``hlo_costs`` holds ``dot_flops`` and
    ``coll_bytes`` per device (``step_costs``' keys, as ``parse_hlo_costs``')."""
    comp = hlo_costs["dot_flops"] / HW["peak_flops"]            # per device
    mem = memory_bytes_per_device(
        cfg, shape, n_dev, microbatches, kv_int8
    ) / HW["hbm_bw"]
    coll = hlo_costs["coll_bytes"] / HW["ici_bw"]
    terms = {"compute": comp, "memory": mem, "collective": coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = hlo_costs["dot_flops"] * n_dev
    return RooflineRow(
        cell=cell or f"{cfg.name}.{shape.name}",
        n_dev=n_dev,
        compute_s=comp,
        memory_s=mem,
        collective_s=coll,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        fix_hint=_FIX_HINTS[dominant],
    )
