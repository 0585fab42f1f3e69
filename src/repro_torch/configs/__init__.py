"""Configurations of the port: the manycore wafer, and the LM architectures
ported so far (``registry.get_config``)."""
