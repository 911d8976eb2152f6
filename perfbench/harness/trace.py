"""The traced run's instrument: ``torch.profiler`` over a slice of the
window, reduced to plain lists that the metric readers read.

Spans are the benchmark's own ``record_function`` regions around its calls
into the program (``bench.*``) and the program's own spans (the backward
spans of ``kernels/ops.py``).  Every device operation (kernel, copy, set)
counts as busy; it is tied to the host span it was issued in through the
correlation id of the runtime call that issued it.

The profiler slows the host's side of what it traces, and reducing its
events takes seconds, so the slice it covers, from ``start`` to ``stop``,
is left out of every rate taken on the host's clock: the drivers record
the slice's bounds (``t_begin``, ``t_end``) and the work done outside it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from harness.yardstick import merged_length, sync

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int, Optional[int]]]   # name, start, end (ns), launch time (ns)
    spans: List[Tuple[str, int, int]]                # host spans: name, start, end (ns)
    launches: List[int]                              # host launch times (ns), sorted
    start: int
    end: int
    matched: int                                     # device ops tied to a launch

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return merged_length([(max(s, self.start), min(e, self.end)) for _, s, e, _ in self.ops
                              if e > self.start and s < self.end]) / 1e9

    def kernels(self, *parts: str) -> List[Tuple[str, int, int, Optional[int]]]:
        """Device ops whose name holds every one of ``parts``."""
        return [o for o in self.ops if all(p in o[0] for p in parts)]

    def named(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def ops_launched_in(self, name: str) -> List[Tuple[str, int, int, Optional[int]]]:
        """Device ops launched inside a host span called ``name``."""
        iv = sorted(self.named(name))
        starts = [s for s, _ in iv]
        out = []
        for op in self.ops:
            t = op[3]
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                out.append(op)
        return out

    def busy_in(self, name: str) -> Optional[float]:
        """Mean device-busy seconds of one span called ``name``: the union of
        the device operations issued inside such spans over their number
        (None where there is no such span)."""
        n = len(self.named(name))
        if not n:
            return None
        return merged_length([(o[1], o[2]) for o in self.ops_launched_in(name)]) / 1e9 / n

    def launches_in(self, s: int, e: int) -> int:
        return bisect.bisect_right(self.launches, e) - bisect.bisect_left(self.launches, s)

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, int] = {}
        for n, s, e, _ in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time summed by the ``bench.*`` span the host was in
        at the middle of each gap ("driver" outside any)."""
        iv = sorted((max(s, self.start), min(e, self.end)) for _, s, e, _ in self.ops
                    if e > self.start and s < self.end)
        gaps, cur = [], self.start
        for s, e in iv:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.end:
            gaps.append((cur, self.end))
        bench = sorted((s, e, n) for n, s, e in self.spans
                       if n.startswith("bench.") and n != "bench.trace")
        starts = [b[0] for b in bench]
        by: Dict[str, int] = {}
        for s, e in gaps:
            mid = (s + e) // 2
            name = "driver"
            # the innermost span holding the gap's middle: the latest
            # started that has not ended (spans nest: a prefill inside an
            # admitting step)
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4, -1), -1):
                if mid <= bench[j][1]:
                    name = bench[j][2][len("bench."):]
                    break
            by[name] = by.get(name, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]


class Tracer:
    """Starts and stops the profiler around a slice of the window and marks
    spans; without tracing every call is a no-op.  ``t_begin`` and
    ``t_end`` bound the slice on the host's clock, profiler start and stop
    included; ``collect`` reduces the events once the window has closed."""

    def __init__(self, on: bool):
        self.on, self.prof, self._win, self.trace = on, None, None, None
        self._stopped = None
        self.t_begin = self.t_end = None

    def warm(self) -> None:
        """Start and stop the profiler once (set-up of a traced run): its
        first start initialises the device tracer, which takes seconds."""
        self.start()
        self.stop()
        self._stopped = None
        self.t_begin = self.t_end = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def done(self) -> bool:
        return self.t_end is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        sync()
        self.t_begin = time.perf_counter()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._win = record_function("bench.trace")
        self._win.__enter__()

    def stop(self) -> None:
        sync()
        self._win.__exit__(None, None, None)
        self.prof.stop()
        self._stopped, self.prof = self.prof, None
        self.t_end = time.perf_counter()

    def collect(self) -> None:
        """Reduce the stopped profiler's events into ``trace``."""
        if self._stopped is not None:
            self.trace = reduce(self._stopped)
            self._stopped = None

    def untraced_s(self, t0: float, t1: float) -> float:
        """Seconds of the window [t0, t1] outside the traced slice."""
        if self.t_begin is None:
            return t1 - t0
        end = t1 if self.t_end is None else self.t_end
        return (t1 - t0) - max(0.0, min(end, t1) - max(self.t_begin, t0))

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def _kind(e) -> str:
    """"device", "launch" (of a kernel), "runtime" (another runtime or driver
    call), "span" or "" (anything else) of a profiler event; by
    ``activity_type()`` where this PyTorch has it, else by device and
    name."""
    name = e.name()
    at = getattr(e, "activity_type", None)
    if at is not None:
        k = at()
        if k in DEVICE_OPS:
            return "device"
        if k in ("cuda_runtime", "cuda_driver"):
            return "launch" if name.startswith(("cudaLaunch", "cuLaunch")) else "runtime"
        return "span" if k == "user_annotation" else ""
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "" if _span_name(name) else "device"
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return "launch"
    user = getattr(e, "is_user_annotation", None)
    return "span" if (user() if user is not None else _span_name(name)) else ""


def _span_name(name: str) -> bool:
    """The benchmark's spans and the program's backward spans (a device
    copy of an annotation bears its name)."""
    return name.startswith("bench.") or (name.endswith("_backward") and "::" not in name)


def reduce(prof) -> Trace:
    evs = prof.profiler.kineto_results.events()
    ops, spans, runtime, launches = [], [], {}, []
    for e in evs:
        kind = _kind(e)
        if kind == "device":
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id(), e.linked_correlation_id()))
        elif kind in ("launch", "runtime"):
            # copies and sets are issued by runtime calls other than launches
            runtime[e.correlation_id()] = e.start_ns()
            if kind == "launch":
                launches.append(e.start_ns())
        elif kind == "span":
            spans.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    tied, matched = [], 0
    for name, s, e, corr, linked in ops:
        t = runtime.get(corr, runtime.get(linked))
        matched += t is not None
        tied.append((name, s, e, t))
    win = [(s, e) for n, s, e in spans if n == "bench.trace"]
    start, end = win[0] if win else (min(o[1] for o in ops), max(o[2] for o in ops))
    return Trace(tied, spans, sorted(launches), start, end, matched)
