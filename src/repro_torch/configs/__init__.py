"""Configurations of the port: the manycore wafer and the LM architectures
(``registry.get_config``)."""
