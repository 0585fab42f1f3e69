"""The synthetic training data of the port (``pipeline``)."""
