"""Simulation configurations of the port (the manycore wafer)."""
