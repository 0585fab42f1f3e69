"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (``granule_step``, ``systolic_step``)."""
