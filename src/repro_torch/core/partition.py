"""Heterogeneous cost-model stage partitioner (port of ``repro/core/partition.py``).

The paper hand-tunes its 2-stage split ("right before the 4th residual block
of layer 3" for the Xeon+iPhone-11 pair, "the entire layer 3" for the
iPhone 16).  This module makes that choice a cost model:

* :func:`split_blocks` — given per-block (flops, boundary_bytes) and a list of
  device profiles (compute rate, link bandwidth), choose cut points that
  minimise the pipeline's bottleneck stage time (compute + boundary transfer).
  Reproduces the paper's split decisions from its own device numbers
  (validated in tests/benchmarks).

* :func:`split_decode` — the SERVING-mode search: decode is sequential per
  token (token t+1 needs token t), so the objective is the *sum* of stage
  step times plus boundary-frame transfers, not the pipelined bottleneck —
  and the binding constraint is each stage fitting its device's
  ``mem_bytes`` (the whole reason to split a decode model at all).

* :func:`plan_pipeline` — homogeneous planning for a pipeline over
  identical devices: stage count S (divisor of the model axis), replica
  factor R, layers-per-stage with padding, and the schedule's tick/bubble
  accounting.

Plain Python over floats: nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.hw.specs import DeviceProfile


# ---------------------------------------------------------------------------
# heterogeneous split (paper §4.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SplitPlan:
    cuts: Tuple[int, ...]              # block index where each next stage starts
    stage_seconds: Tuple[float, ...]   # per-microbatch compute time per stage
    comm_seconds: Tuple[float, ...]    # boundary transfer time after stage i
    bottleneck: float                  # max(stage+comm) — steady-state tick

    @property
    def throughput(self) -> float:
        return 1.0 / self.bottleneck


def _stage_time(flops: float, dev: DeviceProfile, efficiency: float) -> float:
    return flops / (dev.flops * efficiency)


def split_blocks(costs: Sequence[Tuple[float, float]],
                 devices: Sequence[DeviceProfile],
                 efficiency: float = 0.5,
                 train: bool = True) -> SplitPlan:
    """Exhaustive search over cut points (n_blocks choose n_stages-1).

    costs: per-block (flops_fwd, boundary_bytes).  Training multiplies block
    compute by 3 (fwd+bwd) and boundary traffic by 2 (activation + gradient).
    """
    n = len(costs)
    s = len(devices)
    assert 1 <= s <= n
    fmul = 3.0 if train else 1.0
    bmul = 2.0 if train else 1.0

    best: Optional[SplitPlan] = None
    for cuts in itertools.combinations(range(1, n), s - 1):
        bounds = (0,) + cuts + (n,)
        stage_t, comm_t = [], []
        for i in range(s):
            f = sum(c[0] for c in costs[bounds[i]:bounds[i + 1]]) * fmul
            stage_t.append(_stage_time(f, devices[i], efficiency))
            if i < s - 1:
                link = min(devices[i].link_bw, devices[i + 1].link_bw)
                comm_t.append(bmul * costs[bounds[i + 1] - 1][1] / link)
        tick = max(st + (comm_t[i] if i < s - 1 else 0.0)
                   for i, st in enumerate(stage_t))
        plan = SplitPlan(cuts, tuple(stage_t), tuple(comm_t), tick)
        if best is None or plan.bottleneck < best.bottleneck:
            best = plan
    return best


def pipeline_batch_seconds(plan: SplitPlan, n_micro: int) -> float:
    """Steady-state batch time: fill/drain + M ticks of the bottleneck."""
    ramp = sum(plan.stage_seconds) + sum(plan.comm_seconds) - plan.bottleneck
    return ramp + n_micro * plan.bottleneck


def single_device_seconds(costs: Sequence[Tuple[float, float]],
                          dev: DeviceProfile, n_micro: int,
                          efficiency: float = 0.5, train: bool = True) -> float:
    fmul = 3.0 if train else 1.0
    return n_micro * _stage_time(sum(c[0] for c in costs) * fmul, dev, efficiency)


# ---------------------------------------------------------------------------
# decode-mode split (serving; paper §4.3 memory wall + §4.1 topology)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeSplitPlan:
    """A serving split: where to cut, what each step costs, what fits where.

    Unlike :class:`SplitPlan` (training, microbatch-pipelined, bottleneck
    objective), decode steps of one continuous batch are strictly
    sequential — ``step_seconds`` is the SUM of stage compute plus every
    boundary-frame flight, i.e. the per-token latency of the split pair.
    """
    cuts: Tuple[int, ...]              # block index where each next stage starts
    stage_seconds: Tuple[float, ...]   # decode-step compute per stage
    comm_seconds: Tuple[float, ...]    # boundary frame flight after stage i
    stage_mem_bytes: Tuple[float, ...]
    fits: Tuple[bool, ...]             # stage_mem <= device.mem_bytes per stage

    @property
    def step_seconds(self) -> float:
        return sum(self.stage_seconds) + sum(self.comm_seconds)

    @property
    def feasible(self) -> bool:
        return all(self.fits)

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.step_seconds


def split_decode(costs: Sequence[Tuple[float, float, float]],
                 devices: Sequence[DeviceProfile],
                 stage_fixed_mem: Optional[Sequence[float]] = None
                 ) -> DecodeSplitPlan:
    """Exhaustive decode-mode cut search from serving rates + memory.

    costs: per-block ``(share, boundary_bytes, mem_bytes)`` —

    * ``share``: the block's fraction of a FULL-model decode step (shares
      sum to 1), so a stage holding shares ``s`` on a device rated
      ``decode_steps_per_s = r`` for the full model costs ``s / r``
      seconds per token;
    * ``boundary_bytes``: wire bytes of the activation frame crossing the
      link if the NEXT stage starts after this block (per decode step);
    * ``mem_bytes``: resident bytes the block pins on its stage (params +
      its KV/state share).

    ``stage_fixed_mem[i]`` adds per-stage constants (embedding table on
    stage 0, final-norm/head on the last, runtime overheads).

    Feasible plans (every stage within its device's ``mem_bytes``) win
    over infeasible ones; within a class the lowest per-token
    ``step_seconds`` wins — so when the model fits nowhere whole, the
    search trades link time for a cut that fits, and when memory is no
    object it degenerates to "no benefit from splitting" honestly (the
    unsplit latency is always <= any split's, which callers can check by
    passing one device).
    """
    n = len(costs)
    s = len(devices)
    assert 1 <= s <= n
    fixed = tuple(stage_fixed_mem) if stage_fixed_mem is not None \
        else (0.0,) * s
    if len(fixed) != s:
        raise ValueError(f"stage_fixed_mem has {len(fixed)} entries "
                         f"for {s} stages")

    best: Optional[DecodeSplitPlan] = None
    best_key = None
    for cuts in itertools.combinations(range(1, n), s - 1):
        bounds = (0,) + cuts + (n,)
        stage_t, comm_t, mem, fits = [], [], [], []
        for i in range(s):
            blocks = costs[bounds[i]:bounds[i + 1]]
            stage_t.append(sum(c[0] for c in blocks)
                           / devices[i].decode_rate())
            m = sum(c[2] for c in blocks) + fixed[i]
            mem.append(m)
            fits.append(m <= devices[i].mem_bytes)
            if i < s - 1:
                link = min(devices[i].link_bw, devices[i + 1].link_bw)
                comm_t.append(costs[bounds[i + 1] - 1][1] / link)
        plan = DecodeSplitPlan(cuts, tuple(stage_t), tuple(comm_t),
                               tuple(mem), tuple(fits))
        # feasible first; then fastest per-token step; then the spare
        # headroom tie-break (prefer the cut leaving the most slack)
        key = (not plan.feasible, plan.step_seconds,
               -min(devices[i].mem_bytes - mem[i] for i in range(s)))
        if best is None or key < best_key:
            best, best_key = plan, key
    return best


# ---------------------------------------------------------------------------
# homogeneous plan for a pipeline over identical devices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    n_stages: int                     # S
    replicas: int                     # R = model_axis // S (extra DP inside model axis)
    layers_per_stage: int             # ceil(L / S)
    n_pad: int                        # no-op layer slots (masked at runtime)
    n_micro: int                      # M
    schedule: str                     # gpipe | hybrid

    @property
    def slots(self) -> int:
        return self.n_stages * self.layers_per_stage

    def ticks(self) -> int:
        m, s = self.n_micro, self.n_stages
        if self.schedule == "hybrid":
            # fused last-stage F+B: fwd stream M+S-1, bwd stream ends S-2 later
            return m + 2 * s - 2
        return 2 * (m + s - 1)

    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule (work-units idle / total slots)."""
        m, s = self.n_micro, self.n_stages
        # fwd+bwd work per mb per stage = 3 units; GPipe & hybrid both idle
        # 3*(S-1) unit-slots at ramp-up+down (paper Fig.3: same total, spread)
        total = 3.0 * (m + s - 1) * s
        busy = 3.0 * m * s
        return 1.0 - busy / total


def plan_pipeline(n_layers: int, model_axis: int, n_micro: int = 0,
                  schedule: str = "hybrid",
                  candidates: Sequence[int] = (16, 8, 4, 2),
                  max_pad_frac: float = 0.2) -> PipelinePlan:
    """Choose S: prefer the LARGEST stage count whose padding waste stays
    under ``max_pad_frac`` — more stages = fewer layers (weights + Adam
    moments) per device, and HBM is the binding constraint before bubble
    fraction is.
    Falls back to the minimum-padding S when none meets the threshold."""
    feasible = []
    for s in candidates:
        if s > model_axis or model_axis % s:
            continue
        lps = -(-n_layers // s)
        pad = s * lps - n_layers
        m = n_micro or max(2 * s, 4)
        feasible.append(PipelinePlan(s, model_axis // s, lps, pad, m, schedule))
    if not feasible:
        raise ValueError(f"no stage count from {candidates} divides model axis "
                         f"{model_axis}")
    under = [p for p in feasible
             if p.n_pad / max(n_layers, 1) <= max_pad_frac]
    if under:
        return max(under, key=lambda p: p.n_stages)
    return min(feasible, key=lambda p: (p.n_pad, -p.n_stages))
