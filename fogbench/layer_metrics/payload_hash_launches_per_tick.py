"""Kernels a tick launched inside the payload hash (``core/workload.py``'s
``payload_for`` and ``versioned_payload``, the ``wl.payload`` spans, which
nest: a launch counts once), matched to their launch by correlation id."""
from fogbench import spans


def read(view):
    sp = spans.load(view.path)
    kernels = [o for o in sp.launched_in("wl.payload") if o.cat == "kernel"] if sp else []
    return len(kernels) / view.ticks if kernels else None
