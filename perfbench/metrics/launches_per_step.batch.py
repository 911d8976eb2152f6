"""Kernel launches in a decode step that admitted nothing (profiler: every
launch the host made inside the step's span), the mean over the traced
steps."""

from harness.readers import traced_steps


def read(record):
    n = [record.trace.launches_in(s, e) for s, e, r in traced_steps(record, "step.decode")
         if not r.admitted]
    return sum(n) / len(n) if n else None
