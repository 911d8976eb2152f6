"""Roofline share of the forward WKV6 kernel in the traced training steps
(its calls in the forward and in the recomputation of remat alike)."""


def read(record):
    tr, m, mix, ys = record.trace, record.model, record.mix, record.yardstick
    if tr is None:
        return None
    calls = tr.kernels("rwkv6_kernel")
    if not calls:
        return None
    h = m["n_heads"]
    flops, nbytes = ys.rwkv6_call(mix["batch"], mix["seq"], h, m["d_model"] // h)
    time_s = sum(e - s for _, s, e, _ in calls) / 1e9
    return 100.0 * len(calls) * ys.bound(flops, ys.PEAK_BF16_FLOPS, nbytes)[0] / time_s
