"""Sharding rules of the port (``partition``), as ``repro.sharding``."""
