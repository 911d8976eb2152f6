"""Pipeline schedule accounting (paper Fig. 3); a copy of
``repro/core/schedules.py``.

A schedule is a table of per-(tick, stage) work items.  Two schedules:

* ``gpipe``    — forward sweep then backward sweep (AD-reversed).
* ``hybrid``   — the paper's hybrid GPipe/1F1B: the LAST stage fuses its
  forward + loss + its own backward in one tick (the MPSGraph static-graph
  constraint turned into a feature); the backward sweep covers stages
  0..S-2 only and overlaps with the tail of the forward sweep (1F1B-style).

Work-unit convention: fwd = 1, bwd = 2, fused f+b = 3.  These tables are
the one source of the order :mod:`repro_torch.core.pipeline` executes:
its executor walks them tick by tick.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

FWD, BWD, FUSED, IDLE = "F", "B", "FB", "."


@dataclasses.dataclass(frozen=True)
class Tick:
    stage_ops: Tuple[str, ...]         # op per stage at this tick
    mb: Tuple[Optional[int], ...]      # microbatch index per stage (fwd work)


def gpipe_table(n_stages: int, n_micro: int) -> List[Tick]:
    s, m = n_stages, n_micro
    ticks: List[Tick] = []
    for t in range(m + s - 1):                       # forward sweep
        ops, mbs = [], []
        for st in range(s):
            mb = t - st
            ok = 0 <= mb < m
            ops.append(FWD if ok else IDLE)
            mbs.append(mb if ok else None)
        ticks.append(Tick(tuple(ops), tuple(mbs)))
    for t in range(m + s - 1):                       # backward sweep (reversed)
        ops, mbs = [], []
        for st in range(s):
            mb = t - (s - 1 - st)
            ok = 0 <= mb < m
            ops.append(BWD if ok else IDLE)
            mbs.append(mb if ok else None)
        ticks.append(Tick(tuple(ops), tuple(mbs)))
    return ticks


def hybrid_table(n_stages: int, n_micro: int) -> List[Tick]:
    """Paper's hybrid: last stage runs FUSED F+B; other stages run FWD for
    microbatch t-s and BWD for the cotangent arriving from the right
    (1F1B interleave).  Ticks: M + 2S - 2."""
    s, m = n_stages, n_micro
    ticks: List[Tick] = []
    for t in range(m + 2 * s - 2):
        ops, mbs = [], []
        for st in range(s):
            fwd_mb = t - st
            fwd_ok = (0 <= fwd_mb < m) and st < s            # inject window
            if st == s - 1:
                ops.append(FUSED if fwd_ok else IDLE)
                mbs.append(fwd_mb if fwd_ok else None)
                continue
            # backward for mb b arrives at stage st at tick b + (2s - 2 - st)
            bwd_mb = t - (2 * s - 2 - st)
            bwd_ok = 0 <= bwd_mb < m
            if fwd_ok and bwd_ok:
                ops.append(FWD + BWD)
            elif fwd_ok:
                ops.append(FWD)
            elif bwd_ok:
                ops.append(BWD)
            else:
                ops.append(IDLE)
            mbs.append(fwd_mb if fwd_ok else None)
        ticks.append(Tick(tuple(ops), tuple(mbs)))
    return ticks


_COST = {FWD: 1.0, BWD: 2.0, FUSED: 3.0, FWD + BWD: 3.0, IDLE: 0.0}


def schedule_stats(table: List[Tick], n_stages: int, n_micro: int) -> dict:
    """Wall-clock model: each tick costs max over stages of its work units."""
    per_tick = [max(_COST[o] for o in tk.stage_ops) for tk in table]
    wall = sum(per_tick)
    busy = sum(_COST[o] for tk in table for o in tk.stage_ops)
    ideal = 3.0 * n_micro                      # per stage: M fwd + M bwd units
    return {
        "ticks": len(table),
        "wall_units": wall,
        "busy_units": busy,
        "ideal_units": ideal * n_stages,
        "bubble_fraction": 1.0 - (ideal / wall) if wall else 0.0,
        "utilisation": busy / (wall * n_stages) if wall else 0.0,
    }


def render(table: List[Tick]) -> str:
    """ASCII rendering (paper Fig. 3 style), stages as rows."""
    s = len(table[0].stage_ops)
    rows = []
    for st in range(s):
        cells = [f"{tk.stage_ops[st]:>3}" for tk in table]
        rows.append(f"stage{st}: " + " ".join(cells))
    return "\n".join(rows)


def verify_dataflow(table: List[Tick], n_stages: int, n_micro: int,
                    schedule: str) -> None:
    """Invariants: every mb visits every stage in order; fwd precedes bwd."""
    seen_fwd = {}
    for t, tk in enumerate(table):
        for st, mb in enumerate(tk.mb):
            if mb is not None and (FWD in tk.stage_ops[st] or
                                   tk.stage_ops[st] == FUSED):
                seen_fwd[(st, mb)] = t
    for mb in range(n_micro):
        for st in range(n_stages):
            assert (st, mb) in seen_fwd, f"mb {mb} never fwd at stage {st}"
            if st:
                assert seen_fwd[(st, mb)] == seen_fwd[(st - 1, mb)] + 1, \
                    f"mb {mb} skipped a tick between stages {st-1}->{st}"
