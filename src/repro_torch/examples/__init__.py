"""The JAX package's example drivers (``examples/*.py``) on the port, one
module each, run with ``python -m repro_torch.examples.<name>``; on the
card by default, on the host with ``--device cpu``."""
