"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (``granule_step``, ``systolic_step``,
``flash_attention``, ``rglru_scan``, ``slstm_scan``); ``ops`` and ``ref``
are the LM kernels' model-facing wrappers and oracles."""
