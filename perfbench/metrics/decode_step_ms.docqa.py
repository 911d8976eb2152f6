"""Median host time of the engine's steps that admitted nothing (a step
returns once its sampled tokens are on the host), outside the traced
slice."""

from harness.readers import median_ms


def read(record):
    steps = record.host.get("steps") or []
    return median_ms([s.end - s.start for s in steps if not s.admitted and not s.traced])
