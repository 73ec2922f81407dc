"""Host ms a tick that the writer ring's ``ring.*`` spans cover (the
enqueue, the backstop's routing, the drain), as a union of intervals."""
from fogbench import spans

PREFIX = "ring."


def read(view):
    sp = spans.load(view.path)
    names = [n for n in sp.spans if n.startswith(PREFIX)] if sp else []
    ring = spans.union(sp.of(*names)) if names else []
    return sum(b - a for a, b in ring) / 1e3 / view.ticks if ring else None
