"""Named spans over the program's host work, free while nothing records.

``span(name)`` enters ``torch.profiler.record_function(name)`` while a
torch profiler is recording, so the region lands in the trace on the
device trace's clock, nested under the span that entered it.  At every
other time it returns one shared null context and calls nothing else: a
check of the profiler's state (~0.1 us) is all it costs.

``span(name, phase)`` also adds the region's host seconds
(``time.perf_counter``) and one call to ``phase``, a :class:`Phase`,
whether or not a profiler records.  The serving engine keeps one
:class:`Phase` for each of its phases in its ``MetricsCollector``.

The spans of the port, by module:

* ``serving/engine.py``: ``engine.step``, with ``engine.prepare``,
  ``engine.admit`` (``engine.schedule``, ``engine.prefill``,
  ``engine.first_token``, ``engine.paste``), ``engine.decode``,
  ``engine.sample`` and ``engine.retire`` inside it;
* ``launch/train.py`` (``make_step_fn``): ``train.forward``,
  ``train.backward``, ``train.adamw``;
* ``kernels/ops.py``: the backward spans ``flash_attention_backward``,
  ``rmsnorm_backward``, ``rwkv6_backward``, ``mamba2_ssd_backward``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

_NULL = contextlib.nullcontext()


class Phase:
    """Calls and host seconds of one phase; the context that
    ``span(name, phase)`` returns.  A phase is not entered again while it
    runs."""

    __slots__ = ("calls", "seconds", "_t0", "_rf")

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self._t0 = 0.0
        self._rf = None

    def __enter__(self) -> "Phase":
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds += time.perf_counter() - self._t0
        self.calls += 1
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False


def span(name: str, phase: Optional[Phase] = None):
    """The context of one span called ``name`` (see the module docstring)."""
    rf = torch.profiler.record_function(name) if _profiler_enabled() else None
    if phase is None:
        return _NULL if rf is None else rf
    phase._rf = rf
    return phase
