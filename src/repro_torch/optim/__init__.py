"""Optimizers and gradient compression of the port (``optimizer``,
``grad_compression``)."""
