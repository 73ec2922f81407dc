"""The port's ``train_lm`` example driver (``repro_torch.examples.train_lm``)
against the JAX package's ``examples/train_lm.py``, each run in this process
at its smallest arguments with ``--device cpu``, its standard output
compared line by line with the JAX driver's.  The weights come from
``torch.Generator``, so the losses are not JAX's; the steps and their
learning rates are.  The other example drivers are held in
``test_torch_examples.py``.
"""
import re
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)
from torch_examples import jax_example as _jax_example
from torch_examples import port_example as _port_example

from repro_torch.examples import train_lm


def test_train_lm_prints_what_jax_prints(tmp_path):
    """10 steps with a fault at step 5: the same steps listed with the
    same learning rates, and the same closing line but for the losses."""
    args = ["--steps", "10", "--fault-at", "5", "--seq", "32", "--batch", "4"]
    want = _jax_example("train_lm", args + ["--ckpt-dir", str(tmp_path / "jax")])
    got = _port_example(train_lm, args + ["--ckpt-dir", str(tmp_path / "port")])

    def steps(lines):
        return [(m.group(1), m.group(2)) for x in lines
                if (m := re.match(r"\s+step\s+(\d+)\s+loss [\d.]+\s+lr (\S+)", x))]

    assert steps(got) == steps(want) and len(steps(got)) == 10
    assert "train-demo-10m: 10 steps" in got
    tail = "survived injected fault at step 5 via ckpt restart"
    assert got[-1].endswith(tail) and want[-1].endswith(tail)
    assert re.match(r"loss [\d.]+ -> [\d.]+ \((improved|NO IMPROVEMENT)\); ", got[-1])
