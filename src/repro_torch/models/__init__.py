"""Model zoo: composable blocks covering all 10 assigned architectures
(``repro.models``'s names)."""
from repro_torch.models.model import (
    abstract_model,
    decode_cache_specs,
    decode_step,
    forward,
    init_model,
    loss_fn,
    model_axes,
    model_param_defs,
    prefill,
)
from repro_torch.models.params import (
    ParamDef,
    abstract_params,
    init_params,
    logical_axes,
    param_count,
)

__all__ = [
    "abstract_model",
    "decode_cache_specs",
    "decode_step",
    "forward",
    "init_model",
    "loss_fn",
    "model_axes",
    "model_param_defs",
    "prefill",
    "ParamDef",
    "abstract_params",
    "init_params",
    "logical_axes",
    "param_count",
]
