"""repro_torch — the Switchboard simulator ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same channel-graph
IR, partitions and engine state layouts, run with PyTorch tensors, with the
fused engine's resident epoch program and the systolic tile as
hand-written Hopper kernels (``kernels/csrc/``); and the LM stack's
serving path (``launch.serve``), with flash attention, the RG-LRU scan and
the sLSTM scan as hand-written Hopper kernels.  Engines and entry points
run on ``device="cuda"`` unless the caller asks for ``device="cpu"``.
Nothing here imports JAX or the ``repro`` package.
"""
