"""Kernels the tick loop launches a tick (``run_sim``/``sim_tick``): the
profiler's kernels of the traced stretch, without those the benchmark's
draws launched, over its ticks."""


def read(view):
    kernels = view.kernels()
    return len(kernels) / view.ticks if kernels else None
