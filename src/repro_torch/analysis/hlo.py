"""Collective-traffic extraction from compiled HLO text.

``compiled.cost_analysis()`` has no collective term, so we parse the
(post-SPMD, per-device) HLO: every ``all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute`` op contributes wire bytes
computed from its RESULT shape, its replica-group size n, and the standard
ring-transfer factors:

    all-reduce        2(n-1)/n × bytes(result)
    all-gather         (n-1)/n × bytes(result)           (result = gathered)
    reduce-scatter     (n-1)   × bytes(result)           (result = shard)
    all-to-all         (n-1)/n × bytes(result)
    collective-permute          bytes(result)

Async pairs (``-start``/``-done``) are counted once (on start).

A copy of ``repro/analysis/hlo.py`` (a plain-text parser).  Nothing in the
port produces HLO: it reads the reference's compiled-program dumps, and the
port's dry-run fills the same ``collectives`` fields from the strategy's
layout instead, with the same :func:`ring_factor`
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(?P<shape>\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?P<async>-start|-done)?"
    r"\(", re.MULTILINE)

_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_SRC_TGT_RE = re.compile(r"source_target_pairs=\{\{")


def _shape_elems(shape: str) -> List[float]:
    """byte sizes of each array in 'f32[4,8]{1,0}' / '(f32[4], bf16[2,2])'."""
    out = []
    for m in re.finditer(r"([a-z0-9]+)\[([0-9,]*)\]", shape):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        out.append(n * _DTYPE_BYTES[dt])
    return out


def _shape_bytes(shape: str) -> float:
    return float(sum(_shape_elems(shape)))


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:                                  # [groups, group_size] iota form
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


@dataclasses.dataclass
class CollectiveStats:
    ops: List[dict]

    @property
    def wire_bytes(self) -> float:
        return sum(o["wire_bytes"] for o in self.ops)

    @property
    def payload_bytes(self) -> float:
        return sum(o["bytes"] for o in self.ops)

    def by_kind(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            c, b = out.get(o["op"], (0, 0.0))
            out[o["op"]] = (c + 1, b + o["wire_bytes"])
        return out


def ring_factor(op: str, n: int) -> float:
    """Wire bytes per result byte of collective ``op`` over a group of ``n``
    (the ring factors above)."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    return 1.0                             # collective-permute


def parse_collectives(hlo_text: str, n_devices: int,
                      loop_trip_counts: bool = True) -> CollectiveStats:
    """Static per-device collective inventory.

    Note: ops inside while-loop bodies appear ONCE in HLO; the caller scales
    by trip count via cost_analysis cross-check or accepts the static count
    (we report both static and flops-consistent estimates in the roofline).
    """
    ops = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if m.group("async") == "-done":
            continue
        op = m.group("op")
        elems = _shape_elems(m.group("shape"))
        if m.group("async") == "-start" and len(elems) > 1:
            # async-start results are (operand, result[, scratch]) tuples:
            # the RESULT is the largest element
            nbytes = float(max(elems))
        else:
            nbytes = float(sum(elems))
        n = _group_size(line, n_devices)
        wire = ring_factor(op, n) * nbytes
        ops.append({"op": op, "bytes": nbytes, "wire_bytes": wire, "group": n,
                    "line": line.strip()[:160]})
    return CollectiveStats(ops)


def count_op(hlo_text: str, name: str) -> int:
    return len(re.findall(rf"\b{name}\b", hlo_text))
