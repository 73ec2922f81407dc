"""Device ms a tick of the coherence sweep's PyTorch ops: the kernels,
copies and fills launched inside ``tick.delivery`` (the (N, N) delivery
mask) or ``flic.update`` (``update_rows``' ``is_origin`` and ``live``
masks), but not the ``flic_update`` kernel itself."""
from fogbench import spans

KERNEL_NAME = "flic_update"


def read(view):
    sp = spans.load(view.path)
    ops = sp.launched_in("tick.delivery", "flic.update") if sp else []
    return spans.device_ms_per_tick([o for o in ops if KERNEL_NAME not in o.name], view.ticks)
