"""repro_torch — the Switchboard simulator ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same channel-graph
IR, partitions and engine state layouts, run with PyTorch tensors, with the
fused engine's resident epoch program as a hand-written Hopper kernel
(``kernels/csrc/granule_step.cu``).  Engines run on ``device="cuda"``
unless the caller asks for ``device="cpu"``.  Nothing here imports JAX or
the ``repro`` package.
"""
