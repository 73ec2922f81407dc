"""Device ms a tick of the tick's PyTorch operations (``core/simulator.py``,
``flic.py``, ``coherence.py``, ``writeback.py``, ``backing_store.py``):
every kernel, copy and fill of the traced stretch but the program's
hand-written kernels and what the benchmark's draws launched."""


def read(view):
    ops = [o for o in view.ops if not o.hand and not o.draws]
    return sum(o.dur for o in ops) / 1e3 / view.ticks if ops else None
