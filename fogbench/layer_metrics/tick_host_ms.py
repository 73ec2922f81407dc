"""Host ms of one tick (``run_sim``'s ``sim.tick`` span around ``sim_tick``):
the median over the traced stretch's ticks."""
import statistics

from fogbench import spans


def read(view):
    sp = spans.load(view.path)
    ticks = sp.of(spans.TICK) if sp else []
    return statistics.median(b - a for a, b in ticks) / 1e3 if ticks else None
