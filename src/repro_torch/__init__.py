"""PyTorch/CUDA port of the FLIC fog-cache simulator (see ``repro`` for the JAX reference)."""
