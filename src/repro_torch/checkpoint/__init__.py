"""Checkpoints of the port's states (``checkpointing``)."""
