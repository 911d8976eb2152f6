"""Agentic tool-use loop (paper §4.3), port of ``repro/serving/tool_loop.py``
driving the port's :class:`~repro_torch.serving.engine.ServeEngine`.

The paper ran Qwen3-8B through a scripted scenario: begin three vector-DB
searches, then alternately retrieve a result and generate a summary — the
split begin/retrieve tools let searches run on the iOS worker WHILE the LRM
generates.  No pretrained weights ship with the repo, so
the agent policy is the deterministic script from the paper's appendix A.4
and "summarization" is real timed decode work on the locally-served model;
the measured artifact — tool latency disappearing from the critical path —
is identical in structure to the paper's Fig. 7/8.

Two modes:
* ``async_tools=True``  (paper's system): begin all searches up-front, decode
  while they run, retrieve FIFO between summaries.
* ``async_tools=False`` (paper's Fig. 8 baseline): call tool, WAIT for it,
  then summarise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.offload.tools import ToolExecutor
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class Span:
    kind: str          # reason | tool_wait | summarize
    t0: float
    t1: float
    label: str = ""

    @property
    def seconds(self):
        return self.t1 - self.t0


@dataclasses.dataclass
class AgentTrace:
    spans: List[Span] = dataclasses.field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def total(self):
        return self.t_end - self.t_start

    def time_in(self, kind: str) -> float:
        return sum(s.seconds for s in self.spans if s.kind == kind)

    def timeline(self) -> List[dict]:
        return [dict(kind=s.kind, start=round(s.t0 - self.t_start, 4),
                     end=round(s.t1 - self.t_start, 4), label=s.label)
                for s in self.spans]


def _generate(engine: ServeEngine, prompt: np.ndarray, n_tokens: int,
              sampling: Optional[SamplingParams] = None,
              prefix: Optional[np.ndarray] = None) -> None:
    """Timed decode work standing in for LRM reasoning/summarisation.

    ``prefix`` is the scenario scaffold (system prompt + tool-loop
    boilerplate) prepended to EVERY turn — exactly the shape of agentic
    traffic that a prefix-cached engine serves without re-prefilling the
    scaffold on each turn."""
    if prefix is not None:
        prompt = np.concatenate([np.asarray(prefix, np.int32),
                                 np.asarray(prompt, np.int32)])
    engine.submit(prompt, max_new=n_tokens, sampling=sampling)
    engine.run_until_drained()


def run_scenario(engine: ServeEngine, executor: ToolExecutor,
                 queries: List[str], *, async_tools: bool,
                 reason_tokens: int = 12, summary_tokens: int = 24,
                 seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 prefix_tokens: int = 0) -> AgentTrace:
    """The paper's A.4 scenario: N begin_search (async) or N [search+wait]
    (sync), then per query: retrieve -> summarize.

    ``prefix_tokens > 0`` prepends a fixed scenario prefix (seeded, so
    every turn shares it) to each generation turn, driving the engine's
    prefix cache end-to-end: turn 1 populates it, later turns admit
    against shared blocks and (once fully cached) skip prefill."""
    rng = np.random.default_rng(seed)
    vocab = engine.model.cfg.vocab_size
    prompt = lambda: rng.integers(0, vocab, size=8)
    prefix = (np.random.default_rng(seed + 1).integers(
        0, vocab, size=prefix_tokens) if prefix_tokens else None)
    trace = AgentTrace(t_start=time.perf_counter())

    def span(kind, label=""):
        class _S:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                trace.spans.append(Span(kind, self.t0, time.perf_counter(),
                                        label))
        return _S()

    if async_tools:
        # paper's system: queue ALL searches, reason while they run
        for q in queries:
            executor.begin("vector_db_begin_search", query=q, k=5)
        with span("reason", "initial reasoning / planning"):
            _generate(engine, prompt(), reason_tokens, sampling, prefix)
        for q in queries:
            with span("tool_wait", f"retrieve({q})"):
                executor.retrieve()
            with span("summarize", f"summary({q})"):
                _generate(engine, prompt(), summary_tokens, sampling, prefix)
    else:
        # Fig. 8 baseline: tool on the critical path
        with span("reason", "initial reasoning / planning"):
            _generate(engine, prompt(), reason_tokens, sampling, prefix)
        for q in queries:
            executor.begin("vector_db_begin_search", query=q, k=5)
            with span("tool_wait", f"search({q}) [blocking]"):
                executor.retrieve()
            with span("summarize", f"summary({q})"):
                _generate(engine, prompt(), summary_tokens, sampling, prefix)

    trace.t_end = time.perf_counter()
    return trace
