"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, ``init_sim``, the trace rows and the warm-up that
fills the fog."""


def read(run):
    return run.setup_s
