"""Host ms of one tick spent dispatching: the part of each ``sim.tick`` span
that aten ops and CUDA API calls (the hand kernels' launches among them)
cover, as a union of intervals; the median over the stretch's ticks.  The
rest of ``tick_host_ms`` is the interpreter's own."""
import statistics

from fogbench import spans


def read(view):
    sp = spans.load(view.path)
    ticks = sp.of(spans.TICK) if sp else []
    ops = spans.union(sp.host_ops) if sp else []
    per_tick = [spans.covered(ops, a, b) for a, b in ticks]
    return statistics.median(per_tick) / 1e3 if any(per_tick) else None
