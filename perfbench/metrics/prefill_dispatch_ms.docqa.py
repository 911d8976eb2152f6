"""Mean host milliseconds of one prefill dispatch in the engine's
``engine.prefill`` phase: the padded batch, its copies to the device and
the batched prefill call, which returns once the forward is enqueued or
once it waits on the device (the program's counter,
``EngineSnapshot.phases``, over all dispatches).

The counter covers the whole window, the traced slice included, where the
profiler slows the host (4 s of the cell's 50): the reading is biased up,
by the share of the dispatches that fall in the slice times their excess
there."""

from harness.program import phase_ms


def read(record):
    return phase_ms(record, ("engine.prefill",), per="engine.prefill")
