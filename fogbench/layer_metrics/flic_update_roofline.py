"""The coherence sweep kernel (``kernels/csrc/flic_update.cu``): its least
time from the benchmark's count of what the sweep needs
(``fogbench/roofline.py::update_work``; delivery at the (N, K) lanes under
fan-out) over its measured time, in percent."""

from fogbench import roofline

KERNEL = "flic_update"


def work(args, cell):
    return roofline.update_work(*args, fanout=cell.config["fanout"])


def read(view):
    return roofline.share(view, KERNEL)
