"""Deterministic synthetic token streams and image batches."""
