"""Share of the traced stretch in which no operation ran on the device:
1 - busy / window, both from one traced stretch (busy: the union of the
kernels', copies' and fills' intervals in the profiler's trace)."""


def read(view):
    if not view.ops or view.window_s <= 0:
        return None
    return 1.0 - view.busy_s / view.window_s
