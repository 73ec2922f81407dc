"""Host ms a tick of the benchmark's feed, its ``fogbench.draws`` span
(``harness.DRAWS_SPAN``): where the next tick's draws are made, a fixed
cost inside the window."""
from fogbench import spans


def read(view):
    sp = spans.load(view.path)
    draws = sp.of(spans.DRAWS) if sp else []
    return sum(b - a for a, b in draws) / 1e3 / view.ticks if draws else None
