"""Split-tool async offload (paper §3.6/§4.3), a copy of
``repro/offload/tools.py`` on the port's wire codec.

The paper splits a tool into two interfaces — ``begin_*`` starts the call on
the iOS worker, ``retrieve_*`` returns the oldest not-yet-retrieved result
(FIFO) — so the LRM keeps reasoning while tools run.  Here the "iOS worker"
is an offload executor (thread pool standing in for the device; requests and
results cross the boundary through the wire codec, same as the paper's TCP
socket), and the FIFO semantics are exactly the paper's.  The codec decodes
to host torch tensors; the tool sees and returns numpy arrays, as in the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.wire import codec


@dataclasses.dataclass
class ToolEvent:
    name: str
    begin_t: float
    end_t: Optional[float] = None
    retrieved_t: Optional[float] = None

    @property
    def run_seconds(self) -> float:
        return (self.end_t or time.perf_counter()) - self.begin_t


class ToolExecutor:
    """FIFO begin/retrieve tool offload onto a worker pool.

    ``register(name, fn, simulated_seconds=...)`` — the simulated delay is the
    paper's Task.sleep trick (§3.6: the real search took ~10 ms, inflated to
    5 s for visibility).
    """

    def __init__(self, n_workers: int = 2):
        self.pool = ThreadPoolExecutor(max_workers=n_workers,
                                       thread_name_prefix="offload")
        self.tools: Dict[str, Callable] = {}
        self.delays: Dict[str, float] = {}
        self.fifo: Deque[Future] = collections.deque()
        self.events: List[ToolEvent] = []
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable, simulated_seconds: float = 0.0):
        self.tools[name] = fn
        self.delays[name] = simulated_seconds

    # -- the two interfaces the LRM sees (paper A.3) -----------------------
    def begin(self, name: str, **kwargs) -> ToolEvent:
        """vector_db_begin_search-style: enqueue, return immediately."""
        fn = self.tools[name]
        delay = self.delays[name]
        ev = ToolEvent(name=name, begin_t=time.perf_counter())

        payload = codec.dumps({k: np.asarray(v) for k, v in kwargs.items()
                               if isinstance(v, (np.ndarray, int, float))})

        def work():
            decoded = codec.loads(payload)           # worker-side decode
            out = fn(**{**kwargs, **{k: decoded[k].numpy() for k in decoded}})
            if delay:
                time.sleep(delay)                    # paper's Task.sleep
            ev.end_t = time.perf_counter()
            return codec.dumps({"result": np.asarray(out)}) if isinstance(
                out, np.ndarray) else out

        fut = self.pool.submit(work)
        with self._lock:
            self.fifo.append(fut)
            self.events.append(ev)
        return ev

    def retrieve(self, timeout: Optional[float] = None) -> Any:
        """vector_db_retrieve_search_result: oldest not-yet-retrieved (FIFO)."""
        with self._lock:
            if not self.fifo:
                raise LookupError("no pending tool call (FIFO empty)")
            fut = self.fifo.popleft()
        out = fut.result(timeout=timeout)
        for ev in self.events:                      # mark earliest unretrieved
            if ev.retrieved_t is None and ev.end_t is not None:
                ev.retrieved_t = time.perf_counter()
                break
        if isinstance(out, bytes):
            out = codec.loads(out)["result"].numpy()
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self.fifo)

    def shutdown(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
