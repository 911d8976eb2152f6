"""Mean host milliseconds a step in the engine's ``engine.decode`` phase:
the backend's step copying the tokens to the device and enqueueing the
forward, which returns before the device ends; what a decode step
replayed from a CUDA graph would remove (the program's counter,
``EngineSnapshot.phases``, over all steps).

The counter covers the whole window, the traced slice included, where the
profiler slows the host (4 s of the cell's 50): the reading is biased up,
by ~5% on an H100 (4-6% of the steps fall in the slice, each taking
1.5-2x as long)."""

from harness.program import phase_ms


def read(record):
    return phase_ms(record, ("engine.decode",))
