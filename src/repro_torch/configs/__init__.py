"""One module per architecture, as in ``repro.configs``: each exports
``CONFIG`` (the published full-size config) and ``SMOKE_CONFIG`` (a reduced
same-family config for CPU tests)."""
from repro_torch.config import ARCH_IDS, get_arch, get_smoke_arch

__all__ = ["ARCH_IDS", "get_arch", "get_smoke_arch"]
