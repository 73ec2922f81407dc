"""Fog operations simulated per second: every read and write of the cell's
traffic in the window, counted from the benchmark's draws, over the
window's host seconds (one ``run_sim`` call ending in a synchronize)."""


def read(run):
    return run.ops / run.window_s if run.window_s > 0 else None
