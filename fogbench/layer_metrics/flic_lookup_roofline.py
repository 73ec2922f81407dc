"""The dense fog probe kernel (``kernels/csrc/flic_lookup.cu``): its least
time from the benchmark's count of what the probe needs
(``fogbench/roofline.py::lookup_work``; one payload a query, not the
(C, Q, D) block) over its measured time, in percent."""

from fogbench import roofline

KERNEL = "flic_lookup"


def work(args, cell):
    return roofline.lookup_work(*args)


def read(view):
    return roofline.share(view, KERNEL)
