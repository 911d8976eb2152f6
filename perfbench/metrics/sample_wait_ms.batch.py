"""Mean host milliseconds a step in the engine's ``engine.sample`` phase:
the argmax, the sampler's per-lane loop, and the wait for the device to
end the step's forward before the tokens reach the host (the program's
counter, ``EngineSnapshot.phases``, over all steps).  Near 0 while the
host sets the pace; it grows as the device does.

The counter covers the whole window, the traced slice included, where the
profiler slows the host (4 s of the cell's 50): a slower host leaves the
device less to finish, biasing the wait down, and slows the sampler's own
loop, biasing it up; 4-6% of the steps fall in the slice."""

from harness.program import phase_ms


def read(record):
    return phase_ms(record, ("engine.sample",))
