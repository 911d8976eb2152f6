"""The program's own spans and phase counters, reduced for the readers.

The port marks its host work with spans (``repro_torch/runtime/spans.py``):
the serving engine's phases (``engine.*``) and the training step's parts
(``train.*``).  In a traced run they are in ``Trace.spans`` beside the
benchmark's ``bench.*`` spans, on the device trace's clock.  The engine
also counts each phase's calls and host seconds over the whole window:
``EngineSnapshot.phases``, which the serving drivers keep under
``host["snapshot"]``.

A checkout whose program has no such span or counter gives nothing here:
every function returns None or an empty result, and none raises.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

PROGRAM = ("engine.", "train.")
ADMIT = ("engine.schedule", "engine.prefill", "engine.first_token", "engine.paste")


def program_spans(tr) -> List[Tuple[int, int, str]]:
    """(start, end, name) of the program's ``engine.*`` and ``train.*``
    spans, by start (an enclosing span before the spans it holds)."""
    return sorted(((s, e, n) for n, s, e in tr.spans if n.startswith(PROGRAM)),
                  key=lambda x: (x[0], -x[1]))


def device_ops(tr) -> List:
    """The trace's device ops less the device-side copies of program spans:
    where a PyTorch has no ``activity_type`` on its profiler events,
    ``harness/trace.py`` keeps the copy of an ``engine.*`` or ``train.*``
    annotation, which spans its kernels, among the device ops."""
    return [o for o in tr.ops if not o[0].startswith(PROGRAM)]


def idle_gaps(tr) -> List[Tuple[int, int]]:
    """The slice's idle intervals: its time outside every device op, as
    ``Trace.idle_gaps`` takes them."""
    iv = sorted((max(s, tr.start), min(e, tr.end)) for _, s, e, _ in device_ops(tr)
                if e > tr.start and s < tr.end)
    gaps, cur = [], tr.start
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < tr.end:
        gaps.append((cur, tr.end))
    return gaps


def innermost(spans: List[Tuple[int, int, str]], points: Iterable[int]) -> List[Optional[str]]:
    """The innermost of ``spans`` (nested, sorted as :func:`program_spans`
    gives them) that holds each point, None outside all; ``points`` in
    ascending order."""
    out, stack, j = [], [], 0
    for p in points:
        while j < len(spans) and spans[j][0] <= p:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_by_span(tr, within: Optional[str] = None) -> Dict[Optional[str], float]:
    """Idle seconds of the slice by the innermost program span that holds
    each gap's middle (None: none holds it).  ``within``: only the gaps
    whose middle lies in a span whose name starts so (``"bench.step."``).
    Empty where the trace holds no program span."""
    spans = program_spans(tr)
    if not spans:
        return {}
    gaps = idle_gaps(tr)
    if within is not None:
        outer = sorted((s, e) for n, s, e in tr.spans if n.startswith(within))
        starts = [s for s, _ in outer]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= outer[i][1]
        gaps = [g for g in gaps if inside((g[0] + g[1]) // 2)]
    by: Dict[Optional[str], float] = {}
    for (s, e), name in zip(gaps, innermost(spans, [(s + e) // 2 for s, e in gaps])):
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return by


def idle_share_in(tr, names: Tuple[str, ...]) -> Optional[float]:
    """Percent of the slice's idle time whose innermost program span is one
    of ``names``; None without a trace, a program span or idle time."""
    if tr is None:
        return None
    by = idle_by_span(tr)
    total = sum(by.values())
    if not total:
        return None
    return 100.0 * sum(t for n, t in by.items() if n in names) / total


def launched_in(tr, name: str, intervals: Optional[List[Tuple[int, int]]] = None) -> List:
    """Device kernels launched inside a span called ``name`` (and, with
    ``intervals``, inside one of them).  A kernel is tied to the runtime
    call that issued it by correlation id, so one replayed from a graph
    counts at its ``cudaGraphLaunch``.  Where the trace ties kernel
    launches alone (a PyTorch without ``activity_type``), a replayed kernel
    is tied to nothing: with ``intervals`` (steps that end by waiting for
    the device), such a kernel counts in the span it starts after on the
    device, within the same interval."""
    spans = sorted(tr.named(name))
    if intervals is not None:
        spans = [(s, e) for s, e in spans if any(a <= s and e <= b for a, b in intervals)]
        bounds = sorted(intervals)
        firsts = [a for a, _ in bounds]
    starts = [s for s, _ in spans]
    out = []
    for op in device_ops(tr):
        if op[0].startswith(("Memcpy", "Memset")):     # copies and sets: no kernels
            continue
        t = op[3]
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(op)
        elif intervals is not None:
            i = bisect.bisect_right(starts, op[1]) - 1
            j = bisect.bisect_right(firsts, op[1]) - 1
            if i >= 0 and j >= 0 and bounds[j][0] <= spans[i][0] and op[1] <= bounds[j][1]:
                out.append(op)
    return out


def decode_only_steps(tr) -> List[Tuple[int, int]]:
    """The traced ``engine.step`` spans that held no prefill dispatch."""
    pre = sorted(s for s, _ in tr.named("engine.prefill"))
    out = []
    for s, e in tr.named("engine.step"):
        i = bisect.bisect_left(pre, s)
        if i == len(pre) or pre[i] > e:
            out.append((s, e))
    return out


def phase_ms(record, names: Tuple[str, ...], per: str = "engine.step") -> Optional[float]:
    """Host milliseconds in ``names`` over the window, per call of ``per``,
    from the engine's phase counters; None where the engine kept no such
    counter or ``per`` never ran."""
    ph = (record.host.get("snapshot") or {}).get("phases") or {}
    if not all(n in ph for n in names + (per,)) or not ph[per]["calls"]:
        return None
    return 1e3 * sum(ph[n]["seconds"] for n in names) / ph[per]["calls"]
