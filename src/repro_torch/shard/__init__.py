"""Sharding: logical-axis rules resolved to DTensor placements per
parallelism plan (``repro.shard``'s names)."""
from repro_torch.shard.partition import (
    Plan,
    PLANS,
    axes_to_pspec,
    current_rules,
    params_pspecs,
    shard_act,
    use_rules,
)

__all__ = [
    "Plan",
    "PLANS",
    "axes_to_pspec",
    "current_rules",
    "params_pspecs",
    "shard_act",
    "use_rules",
]
