"""Mean host milliseconds a step of the engine's own Python work:
``engine.prepare`` (the lanes' growth, twice, and the token array),
``engine.schedule`` (the queue, reservations and the split of an
admission round) and ``engine.retire`` (the per-lane append and finish
loop); what no CUDA graph removes (the program's counters,
``EngineSnapshot.phases``, over all steps).

The counters cover the whole window, the traced slice included, where the
profiler slows the host (4 s of the cell's 50): the reading is biased up,
by ~5% on an H100 (4-6% of the steps fall in the slice, each taking
1.5-2x as long)."""

from harness.program import phase_ms


def read(record):
    return phase_ms(record, ("engine.prepare", "engine.schedule", "engine.retire"))
