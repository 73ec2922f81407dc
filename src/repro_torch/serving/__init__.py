"""Serving: FLIC-paged KV cache + continuous-batching engine
(``repro.serving``'s names)."""
from repro_torch.serving.kv_cache import FlicPageManager, PagePool
from repro_torch.serving.engine import ServeEngine, Request

__all__ = ["FlicPageManager", "PagePool", "ServeEngine", "Request"]
