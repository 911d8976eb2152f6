"""Device kernels launched inside ``engine.decode`` in a traced step that
admitted nothing (an ``engine.step`` span holding no ``engine.prefill``),
the mean over such steps.  A kernel is tied to the runtime call that
issued it, so one replayed from a CUDA graph counts at its
``cudaGraphLaunch``: the count survives a graphed step, which the host's
launch count (``launches_per_step.batch``) does not.

A count, which the profiler's slowing of the host does not move."""

from harness.program import decode_only_steps, launched_in


def read(record):
    tr = record.trace
    if tr is None:
        return None
    steps = decode_only_steps(tr)
    if not steps:
        return None
    return len(launched_in(tr, "engine.decode", steps)) / len(steps)
