"""Arithmetic that several metric readers share.  A reader returns None
where its cell gave it nothing to read (no trace, no such kernel, no such
step); it never returns 0 for a share of a roofline or of a peak."""

from __future__ import annotations

import statistics
from typing import List, Optional

from harness import yardstick as ys


def dense_params(m, head: bool = True) -> float:
    """Parameters a token's forward pass multiplies by in the dense decoder:
    every layer's projections and MLP, and (``head``) the output head, tied
    or not."""
    d, h, g, dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    layer = d * h * dh + 2 * d * g * dh + h * dh * d + 3 * d * f
    return float(m["n_layers"] * layer + (d * m["vocab_size"] if head else 0))


def traced_steps(record, label: str) -> List:
    """(span start, span end, host record) of every traced step that ran in
    a span named ``bench.<label>``, in order."""
    tr = record.trace
    if tr is None:
        return []
    recs = [s for s in record.host["steps"] if s.traced and s.label == label]
    spans = sorted(tr.named("bench." + label))
    if len(spans) != len(recs):
        return []
    return [(s, e, r) for (s, e), r in zip(spans, recs)]


def decode_share(record, layout: str) -> Optional[float]:
    """Roofline share of the decode-attention kernel over the traced steps
    that decoded without admitting: the bound of each call (the live
    positions of the step's running lanes; every lane's query, output and
    mask row) over the kernel's device time."""
    m, tr = record.model, record.trace
    bound_s = time_s = 0.0
    for s, e, r in traced_steps(record, "step.decode"):
        if r.admitted or not r.lanes:
            continue
        calls = [o for o in tr.ops if "decode_" in o[0] and layout in o[0]
                 and o[3] is not None and s <= o[3] <= e]
        eng = record.mix["engine"]
        flops, nbytes = ys.decode_call(eng["max_batch"], r.live, m["n_heads"], m["n_kv_heads"],
                                       m["head_dim"], eng["max_len"])
        bound_s += len(calls) * ys.bound(flops, ys.PEAK_BF16_FLOPS, nbytes)[0]
        time_s += sum(o[2] - o[1] for o in calls) / 1e9
    return 100.0 * bound_s / time_s if time_s else None


def flash_share(record) -> Optional[float]:
    """Roofline share of the flash kernel over the traced prefill dispatches:
    each dispatch's layers x the bound of one causal call at its (batch,
    bucket), over the device time of the flash kernels it launched."""
    m, tr = record.model, record.trace
    if tr is None:
        return None
    spans = sorted(tr.named("bench.prefill"))
    shapes = record.host["prefills"]
    if not spans or len(spans) != len(shapes):
        return None
    bound_s = time_s = 0.0
    for (s, e), (b, t) in zip(spans, shapes):
        calls = [o for o in tr.ops if "flash_attention" in o[0] and o[3] is not None
                 and s <= o[3] <= e]
        if not calls:
            continue
        flops, nbytes = ys.flash_call(b, t, m["n_heads"], m["n_kv_heads"], m["head_dim"])
        bound_s += m["n_layers"] * ys.bound(flops, ys.PEAK_BF16_FLOPS, nbytes)[0]
        time_s += sum(o[2] - o[1] for o in calls) / 1e9
    return 100.0 * bound_s / time_s if time_s else None


def idle_share(record) -> Optional[float]:
    """Share of the window outside the traced slice in which the device
    waits: each kind of step the driver ran there (``host.untraced.steps``)
    at the mean device-busy time of its traced steps, over those seconds.
    The profiler slows the host, not the device, so a traced step's busy
    time stands for an untraced one's; the traced slice's own idle time
    would measure the profiler.  A kind of step that no traced step shows
    takes the mean over all traced steps."""
    tr, u = record.trace, record.host.get("untraced")
    if tr is None or not u or u["seconds"] <= 0:
        return None
    busy = {label: tr.busy_in("bench." + label) for label in u["steps"]}
    spans = [s for label in busy for s in tr.named("bench." + label)]
    if not spans:
        return None
    every = sum(b * len(tr.named("bench." + label)) for label, b in busy.items()
                if b is not None) / len(spans)
    need = sum(n * (every if busy[label] is None else busy[label])
               for label, n in u["steps"].items())
    return 100.0 * (1.0 - need / u["seconds"])


def serve_flops(m, prompt: int, generated: int) -> float:
    """Operations of serving one request as the program computes it: 2 x
    the layers' parameters for every prompt token (padding left out) and
    the head once, at the prompt's last position, which gives the first
    token; 2 x all parameters for every later token; attention, 4 H Dh a
    layer for each (query, key) pair, causal over the prompt, then each
    later token over every position up to its own."""
    per_pair = 4.0 * m["n_heads"] * m["head_dim"] * m["n_layers"]
    pairs = ys.flash_pairs(prompt, prompt, True) if prompt else 0
    g = max(generated - 1, 0)
    pairs += g * (prompt + 1) + g * (g - 1) // 2
    return (2.0 * dense_params(m, head=False) * prompt
            + 2.0 * (dense_params(m) - dense_params(m, head=False)) * (1 if generated else 0)
            + 2.0 * dense_params(m) * g + per_pair * pairs)


def untraced_serve_flops(record) -> float:
    """:func:`serve_flops` of the window's work outside the traced slice:
    all of it, less what the requests did between the slice's start and
    its stop."""
    h, m = record.host, record.model
    done = lambda reqs: sum(serve_flops(m, p, g) for p, g in reqs if g)
    u = h["untraced"]
    return done(h["requests"]) - done(u["at_stop"]) + done(u["at_start"])


def median_ms(xs) -> Optional[float]:
    return 1e3 * statistics.median(xs) if xs else None
