"""Device ms a tick of the fog probe's PyTorch ops: the kernels, copies and
fills launched inside ``tick.probe`` (the probe, the election and the LRU
refresh), but not the ``flic_lookup`` kernel."""
from fogbench import spans

KERNEL_NAME = "flic_lookup"


def read(view):
    sp = spans.load(view.path)
    ops = sp.launched_in("tick.probe") if sp else []
    return spans.device_ms_per_tick([o for o in ops if KERNEL_NAME not in o.name], view.ticks)
