"""Shared utilities: hashing and tree helpers (``repro.utils``'s names)."""
from repro_torch.utils.hashing import hash_u32, hash2_u32, splitmix32
from repro_torch.utils.trees import tree_bytes, tree_param_count, tree_flatten_with_paths

__all__ = [
    "hash_u32",
    "hash2_u32",
    "splitmix32",
    "tree_bytes",
    "tree_param_count",
    "tree_flatten_with_paths",
]
