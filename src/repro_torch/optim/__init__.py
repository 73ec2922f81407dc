"""Optimizers and distributed-optimization tricks."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    compress_topk,
    decompress_topk,
    int8_dequantize,
    int8_quantize,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "warmup_cosine",
    "compress_topk",
    "decompress_topk",
    "int8_quantize",
    "int8_dequantize",
]
