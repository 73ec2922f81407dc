"""The window's peak of device memory in GiB: ``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start.  How large a fog
fits on one card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
