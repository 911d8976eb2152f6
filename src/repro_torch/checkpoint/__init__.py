"""Checkpoints of parameter and optimizer trees on the wire protocol."""
