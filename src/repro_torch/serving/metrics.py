"""Serving metrics: per-request latency accounting + engine-level counters.

Definitions (standard serving vocabulary):

* **TTFT** — time to first token: ``first_token_t - submitted_t`` (includes
  queueing delay, which is the whole point of measuring it per policy).
* **TPOT** — time per output token after the first:
  ``(done_t - first_token_t) / (n_tokens - 1)``.
* **tokens/s** — generated tokens over the engine's active wall-clock.
* **queue depth / slot utilisation** — step-weighted means sampled once per
  engine step, i.e. what the engine actually saw while running.

``MetricsCollector`` is pure bookkeeping (no jax); the engine feeds it
events and asks for a :class:`EngineSnapshot` — a frozen, structured view
suitable for logging, benches, and assertions in tests.

It also keeps the host time of the engine's phases (:data:`PHASES`): each
phase's calls and seconds on the wall clock (``time.perf_counter``), never
on the engine's injectable clock, which a fleet runs as a simulated clock
that does not move within a step.  ``MetricsCollector.phase(name)`` is the
phase's span (:mod:`repro_torch.runtime.spans`), and
``EngineSnapshot.phases`` carries the counters outside the snapshot's
equality, so two identical runs still give equal snapshots.

SLO accounting (fleet/scale plane) lives here too: :class:`SLOClass`
declares a traffic class's TTFT/TPOT targets, :func:`slo_report` folds
per-request outcomes into an :class:`SLOReport` with per-class p50/p99
latencies and **attainment** — the fraction of *offered* requests that
completed within their class targets.  Requests the system never served
(admission-shed, capacity-rejected, deadline-expired) count as misses:
shedding load keeps served latency pretty, but attainment is measured
against everything the users asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.spans import Phase, span

# the engine's phases: ``engine.step`` holds the others, ``engine.admit``
# holds ``engine.schedule``, ``engine.prefill`` (one a dispatch),
# ``engine.first_token`` and ``engine.paste``
PHASES = ("engine.step", "engine.prepare", "engine.admit", "engine.schedule",
          "engine.prefill", "engine.first_token", "engine.paste", "engine.decode",
          "engine.sample", "engine.retire")


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    count: int
    mean: float
    p50: float
    p95: float
    max: float

    @classmethod
    def of(cls, xs: List[float]) -> "LatencyStats":
        return cls(count=len(xs), mean=_mean(xs),
                   p50=_percentile(xs, 0.50), p95=_percentile(xs, 0.95),
                   max=max(xs) if xs else float("nan"))


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """One structured reading of the engine's counters; see module docstring
    for the latency definitions."""
    completed: int
    rejected: int
    expired: int
    steps: int
    generated_tokens: int
    wall_s: float
    tokens_per_s: float
    ttft: LatencyStats
    tpot: LatencyStats
    queue_wait: LatencyStats
    queue_depth_mean: float
    queue_depth_now: int
    slot_utilization: float            # mean fraction of busy lanes per step
    busy_lanes_mean: float             # sustained concurrency (lanes/step)
    prefill_dispatches: int
    prefill_requests: int
    prefill_batch_mean: float          # requests amortised per dispatch
    prefill_tokens: int                # padded tokens actually prefilled
    # paged-KV accounting (all zero on a dense-layout engine)
    preemptions: int                   # lanes evicted on block exhaustion
    resumes: int                       # preempted requests re-admitted
    kv_blocks_total: int
    kv_blocks_peak: int                # high-watermark blocks in use
    kv_block_utilization: float        # step-weighted mean in_use fraction
    # prefix-cache accounting (zero unless EngineConfig.prefix_cache)
    prefix_lookups: int                # admissions that queried the cache
    prefix_hit_tokens: int             # context tokens served from cache
    prefix_query_tokens: int           # context tokens looked up
    prefix_hit_rate: float             # token-weighted hits / lookups
    prefix_hit_series: Tuple[float, ...]   # per-admission hit fraction
    prefill_skipped: int               # fully-cached prompts: no prefill
    cow_splits: int                    # shared blocks privatised on write
    kv_shared_blocks_peak: int         # high-watermark refcount>=2 blocks
    cache_evictions: int               # cached free blocks reclaimed
    # speculative-decoding accounting (zero on non-speculative engines)
    spec_rounds: int = 0               # draft->verify rounds run
    spec_drafted_tokens: int = 0       # draft proposals shipped to verify
    spec_accepted_tokens: int = 0      # proposals the target agreed with
    spec_acceptance_rate: float = 0.0  # accepted / drafted (token-weighted)
    spec_accepted_series: Tuple[int, ...] = ()  # accepted count per round
    # host time of the engine's phases, {name: {"calls", "seconds"}}, on
    # the wall clock: outside equality, no two runs share it
    phases: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict,
                                                             compare=False)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# SLO accounting (fleet / scale plane)
# ---------------------------------------------------------------------------
# terminal request outcomes, as used by slo_report's ``outcome`` array
OUTCOME_DONE = 0        # completed: latencies are valid
OUTCOME_SHED = 1        # admission controller rejected at submit (predicted miss)
OUTCOME_REJECTED = 2    # capacity reject: every eligible queue was full
OUTCOME_EXPIRED = 3     # deadline passed while still queued


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One traffic class's service-level objective (targets in seconds).
    ``ttft_s`` also feeds predicted-TTFT admission control when a request
    carries no explicit deadline; ``inf`` disables a bound."""
    name: str
    ttft_s: float = float("inf")
    tpot_s: float = float("inf")


class _NanEq:
    """Field-wise equality that treats NaN == NaN as true.  SLO reports
    carry NaN for undefined stats (percentiles of an empty class, served
    attainment with zero completions); determinism tests compare whole
    snapshots, and two bit-identical runs must compare equal even where a
    stat is undefined."""

    @staticmethod
    def _eq(a, b) -> bool:
        if isinstance(a, tuple) and isinstance(b, tuple):
            return (len(a) == len(b)
                    and all(_NanEq._eq(x, y) for x, y in zip(a, b)))
        return bool(a == b) or (a != a and b != b)

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        return self._eq(dataclasses.astuple(self), dataclasses.astuple(other))


@dataclasses.dataclass(frozen=True, eq=False)
class ClassSLOReport(_NanEq):
    """SLO outcome for one traffic class.  ``attainment`` is met/offered
    (unserved requests are misses); ``served_attainment`` is met/completed
    (how the served ones fared)."""
    name: str
    offered: int
    completed: int
    shed: int
    rejected: int
    expired: int
    ttft_p50: float
    ttft_p99: float
    tpot_p50: float
    tpot_p99: float
    met: int
    attainment: float
    served_attainment: float


@dataclasses.dataclass(frozen=True, eq=False)
class SLOReport(_NanEq):
    """Fleet-wide SLO rollup: per-class reports + offered-weighted totals.
    ``goodput_tokens_per_s`` counts only tokens of SLO-met requests — the
    throughput users actually experienced within target."""
    classes: Tuple[ClassSLOReport, ...]
    offered: int
    completed: int
    shed: int
    rejected: int
    expired: int
    met: int
    attainment: float
    served_attainment: float
    goodput_tokens_per_s: float
    tokens_per_s: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def slo_report(specs: Sequence[SLOClass], class_ids: Sequence[int],
               ttft_s: Sequence[float], tpot_s: Sequence[float],
               tokens: Sequence[int], outcome: Sequence[int],
               span_s: float) -> SLOReport:
    """Fold per-request outcomes into an :class:`SLOReport`.

    Parallel arrays, one entry per *offered* request: its class id, TTFT
    and TPOT in seconds (ignored unless ``outcome == OUTCOME_DONE``; TPOT
    may be NaN for single-token requests and then counts as met), generated
    tokens, and terminal outcome (``OUTCOME_*``).  ``span_s`` is the span
    the token rates are normalised over (sim or wall seconds).
    """
    n = len(class_ids)
    reports: List[ClassSLOReport] = []
    tot_met = tot_done = tot_shed = tot_rej = tot_exp = 0
    good_tokens = all_tokens = 0
    for cid, spec in enumerate(specs):
        idx = [i for i in range(n) if class_ids[i] == cid]
        done = [i for i in idx if outcome[i] == OUTCOME_DONE]
        shed = sum(1 for i in idx if outcome[i] == OUTCOME_SHED)
        rej = sum(1 for i in idx if outcome[i] == OUTCOME_REJECTED)
        exp = sum(1 for i in idx if outcome[i] == OUTCOME_EXPIRED)
        ttfts = [float(ttft_s[i]) for i in done]
        tpots = [float(tpot_s[i]) for i in done
                 if tpot_s[i] == tpot_s[i]]          # drop NaN (n_tokens == 1)
        met = 0
        for i in done:
            ok_ttft = float(ttft_s[i]) <= spec.ttft_s
            tp = float(tpot_s[i])
            ok_tpot = (tp != tp) or tp <= spec.tpot_s
            if ok_ttft and ok_tpot:
                met += 1
                good_tokens += int(tokens[i])
            all_tokens += int(tokens[i])
        offered = len(idx)
        reports.append(ClassSLOReport(
            name=spec.name, offered=offered, completed=len(done),
            shed=shed, rejected=rej, expired=exp,
            ttft_p50=_percentile(ttfts, 0.50), ttft_p99=_percentile(ttfts, 0.99),
            tpot_p50=_percentile(tpots, 0.50), tpot_p99=_percentile(tpots, 0.99),
            met=met,
            attainment=met / offered if offered else float("nan"),
            served_attainment=met / len(done) if done else float("nan")))
        tot_met += met
        tot_done += len(done)
        tot_shed += shed
        tot_rej += rej
        tot_exp += exp
    offered = sum(r.offered for r in reports)
    return SLOReport(
        classes=tuple(reports), offered=offered, completed=tot_done,
        shed=tot_shed, rejected=tot_rej, expired=tot_exp, met=tot_met,
        attainment=tot_met / offered if offered else float("nan"),
        served_attainment=tot_met / tot_done if tot_done else float("nan"),
        goodput_tokens_per_s=good_tokens / span_s if span_s > 0 else 0.0,
        tokens_per_s=all_tokens / span_s if span_s > 0 else 0.0)


class MetricsCollector:
    def __init__(self, n_slots: int, n_blocks: int = 0):
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.queue_wait: List[float] = []
        self.completed = 0
        self.generated_tokens = 0
        self.steps = 0
        self._depth_sum = 0
        self._busy_sum = 0
        self._blocks_sum = 0
        self.preemptions = 0
        self.resumes = 0
        self.prefill_dispatches = 0
        self.prefill_requests = 0
        self.prefill_tokens = 0
        self.prefix_lookups = 0
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.prefix_hit_series: List[float] = []
        self.prefill_skipped = 0
        self.spec_rounds = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_accepted_series: List[int] = []
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._phases = {name: Phase() for name in PHASES}

    def phase(self, name: str) -> Phase:
        """The span of one of the engine's :data:`PHASES`, counted."""
        return span(name, self._phases[name])

    # ------------------------------------------------------------------
    def on_prefill(self, n_requests: int, n_tokens: int = 0) -> None:
        self.prefill_dispatches += 1
        self.prefill_requests += n_requests
        self.prefill_tokens += n_tokens

    def on_admit(self, req, now: float) -> None:
        self.queue_wait.append(now - req.submitted_t)
        if self._t_first is None:
            self._t_first = now

    def on_preempt(self, req) -> None:
        self.preemptions += 1

    def on_prefix_lookup(self, hit_tokens: int, query_tokens: int) -> None:
        self.prefix_lookups += 1
        self.prefix_hit_tokens += hit_tokens
        self.prefix_query_tokens += query_tokens
        self.prefix_hit_series.append(
            hit_tokens / query_tokens if query_tokens else 0.0)

    def on_prefill_skip(self) -> None:
        self.prefill_skipped += 1

    def on_spec_round(self, drafted: int, accepted: int) -> None:
        """One speculative round: ``drafted`` proposals were verified,
        ``accepted`` of them matched the target's own samples."""
        self.spec_rounds += 1
        self.spec_drafted_tokens += drafted
        self.spec_accepted_tokens += accepted
        self.spec_accepted_series.append(accepted)

    def on_resume(self, req, now: float) -> None:
        self.resumes += 1
        if self._t_first is None:
            self._t_first = now

    def on_step(self, queue_depth: int, busy_slots: int, now: float,
                blocks_in_use: int = 0) -> None:
        self.steps += 1
        self._depth_sum += queue_depth
        self._busy_sum += busy_slots
        self._blocks_sum += blocks_in_use
        self._t_last = now

    def on_finish(self, req, now: float) -> None:
        self.completed += 1
        n = len(req.out_tokens)
        self.generated_tokens += n
        if req.first_token_t is not None:
            self.ttft.append(req.first_token_t - req.submitted_t)
            if n > 1 and req.done_t is not None:
                self.tpot.append((req.done_t - req.first_token_t) / (n - 1))
        self._t_last = now

    # ------------------------------------------------------------------
    def snapshot(self, *, queue_depth_now: int = 0, rejected: int = 0,
                 expired: int = 0, kv_blocks_peak: int = 0,
                 kv_shared_blocks_peak: int = 0, cow_splits: int = 0,
                 cache_evictions: int = 0) -> EngineSnapshot:
        wall = 0.0
        if self._t_first is not None and self._t_last is not None:
            wall = max(self._t_last - self._t_first, 0.0)
        return EngineSnapshot(
            completed=self.completed,
            rejected=rejected,
            expired=expired,
            steps=self.steps,
            generated_tokens=self.generated_tokens,
            wall_s=wall,
            tokens_per_s=self.generated_tokens / wall if wall > 0 else float("nan"),
            ttft=LatencyStats.of(self.ttft),
            tpot=LatencyStats.of(self.tpot),
            queue_wait=LatencyStats.of(self.queue_wait),
            queue_depth_mean=self._depth_sum / self.steps if self.steps else 0.0,
            queue_depth_now=queue_depth_now,
            slot_utilization=(self._busy_sum / (self.steps * self.n_slots)
                              if self.steps else 0.0),
            busy_lanes_mean=self._busy_sum / self.steps if self.steps else 0.0,
            prefill_dispatches=self.prefill_dispatches,
            prefill_requests=self.prefill_requests,
            prefill_batch_mean=(self.prefill_requests / self.prefill_dispatches
                                if self.prefill_dispatches else 0.0),
            prefill_tokens=self.prefill_tokens,
            preemptions=self.preemptions,
            resumes=self.resumes,
            kv_blocks_total=self.n_blocks,
            kv_blocks_peak=kv_blocks_peak,
            kv_block_utilization=(
                self._blocks_sum / (self.steps * self.n_blocks)
                if self.steps and self.n_blocks else 0.0),
            prefix_lookups=self.prefix_lookups,
            prefix_hit_tokens=self.prefix_hit_tokens,
            prefix_query_tokens=self.prefix_query_tokens,
            prefix_hit_rate=(self.prefix_hit_tokens / self.prefix_query_tokens
                             if self.prefix_query_tokens else 0.0),
            prefix_hit_series=tuple(self.prefix_hit_series),
            prefill_skipped=self.prefill_skipped,
            cow_splits=cow_splits,
            kv_shared_blocks_peak=kv_shared_blocks_peak,
            cache_evictions=cache_evictions,
            spec_rounds=self.spec_rounds,
            spec_drafted_tokens=self.spec_drafted_tokens,
            spec_accepted_tokens=self.spec_accepted_tokens,
            spec_acceptance_rate=(
                self.spec_accepted_tokens / self.spec_drafted_tokens
                if self.spec_drafted_tokens else 0.0),
            spec_accepted_series=tuple(self.spec_accepted_series),
            phases={name: {"calls": p.calls, "seconds": p.seconds}
                    for name, p in self._phases.items()},
        )
