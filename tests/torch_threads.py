"""The size of PyTorch's intra-op thread pool in a test process of the port.

Under pytest-xdist the test workers share the host's cores with each other,
with JAX's own thread pools and with the rank groups that some tests spawn
(whose ranks take one thread each).  A torch process left at its default
takes every core for its pool, and the pools then contend.  Importing this
module gives each worker its share of the cores (``os.cpu_count()`` over
``PYTEST_XDIST_WORKER_COUNT``, at least one); a run in one process keeps
the default.  Not a test module.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
