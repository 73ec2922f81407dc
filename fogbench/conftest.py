"""The benchmark's CPU tests import the program from ``src``; under
pytest-xdist each worker's torch takes its share of the cores, as the
suite's ``tests/torch_threads.py`` gives it."""
import os
import sys
from pathlib import Path

import torch

SRC = str(Path(__file__).resolve().parent.parent / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
