"""Operations of the window's work (prompt tokens without padding and
generated tokens, 2 x parameters each, the head once a prompt, plus
attention: :func:`harness.readers.serve_flops`) over the window's seconds,
as a share of 989 TFLOP/s (bf16).  The traced slice, where the profiler
slows the host, is left out of both."""

from harness.readers import untraced_serve_flops


def read(record):
    h = record.host
    if "requests" not in h or h["untraced"]["seconds"] <= 0:
        return None
    return (100.0 * untraced_serve_flops(record) / h["untraced"]["seconds"]
            / record.yardstick.PEAK_BF16_FLOPS)
