"""Device milliseconds a training step of the kernels launched inside the
program's ``train.adamw`` span (the AdamW update, leaf by leaf), over the
traced steps.

Device time, which the profiler's slowing of the host barely moves: the
kernels run as long inside the slice as outside it, so the reading is
unbiased but for the profiler's own per-kernel cost on the device."""

from harness.program import launched_in


def read(record):
    tr = record.trace
    if tr is None:
        return None
    steps = len(tr.named("train.adamw"))
    ops = launched_in(tr, "train.adamw")
    if not steps or not ops:
        return None
    return sum(e - s for _, s, e, _ in ops) / 1e6 / steps
