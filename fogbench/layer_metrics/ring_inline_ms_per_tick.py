"""Device ms a tick of the writer ring's ops: the kernels, copies and fills
launched inside any ``ring.*`` span (the FIFO or keyed enqueue, the
backstop's routing of fog misses, the drain and its drained rows)."""
from fogbench import spans

PREFIX = "ring."


def read(view):
    sp = spans.load(view.path)
    names = [n for n in sp.spans if n.startswith(PREFIX)] if sp else []
    return spans.device_ms_per_tick(sp.launched_in(*names), view.ticks) if names else None
