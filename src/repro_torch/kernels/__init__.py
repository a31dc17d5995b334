"""Kernels of the port: CUDA sources in ``csrc/``, their wrappers, the plain
PyTorch versions (``ref``) and the fused driver (``ops``)."""
