"""The dense fog probe (``simulator._probe_all_caches`` -> ``flic_lookup``):
its kernel's device ms a tick in the traced stretch, by the kernel's name."""

KERNEL_NAME = "flic_lookup"


def read(view):
    runs = view.named(KERNEL_NAME)
    return sum(o.dur for o in runs) / 1e3 / view.ticks if runs else None
