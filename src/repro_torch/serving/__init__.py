"""Continuous-batching serving engine over the dense KV backend."""
