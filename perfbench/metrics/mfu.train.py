"""6 x non-embedding parameters x tokens of the window over its seconds,
as a share of 989 TFLOP/s (bf16); remat's recomputation is not counted.
The traced steps, where the profiler slows the host, are left out of both."""


def read(record):
    h, ys = record.host, record.yardstick
    u = h.get("untraced")
    if "params_nonembed" not in h or not u or u["seconds"] <= 0:
        return None
    return 100.0 * 6.0 * h["params_nonembed"] * u["tokens"] / u["seconds"] / ys.PEAK_BF16_FLOPS
