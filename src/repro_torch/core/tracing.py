"""Named host spans on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` session records, and one shared null context otherwise,
so a span costs a flag test when nobody traces.  Under a profiler a span is
a ``user_annotation`` event of the Chrome trace, on the same clock as the
kernels it launches: a device operation, or an idle stretch of the card, is
put down to the span its launch, or the host, was in.  Span names and what
reads them: ``PERF.md`` section 3.

``torch.autograd._profiler_enabled`` is private; it was checked on torch
2.11 (CUDA build) and 2.13 (CPU build).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in a running profiler's trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
