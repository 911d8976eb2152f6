"""Device time a training step spends in kernels launched inside the
program's ``rwkv6_backward`` span (WKV6's backward), over the traced steps."""


def read(record):
    tr = record.trace
    if tr is None:
        return None
    steps = len(tr.named("bench.train.step"))
    ops = tr.ops_launched_in("rwkv6_backward")
    if not steps or not ops:
        return None
    return sum(e - s for _, s, e, _ in ops) / 1e6 / steps
