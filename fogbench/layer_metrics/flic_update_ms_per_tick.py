"""The coherence sweep (``core/flic.py::update_rows`` -> ``flic_update``): its
kernel's device ms a tick in the traced stretch, by the kernel's name."""

KERNEL_NAME = "flic_update"


def read(view):
    runs = view.named(KERNEL_NAME)
    return sum(o.dur for o in runs) / 1e3 / view.ticks if runs else None
