"""Runtime invariant guards: seeded-replay checks (a copy of
``repro/runtime/guard.py`` without ``TraceGuard``).

:func:`seeded_replay_check` runs a seeded simulation twice and diffs the
snapshots field by field (NaN-aware, :func:`diff_snapshots`).  Any
divergence means hidden wall-clock or global-RNG state leaked into a sim
path.  It needs numpy only when the snapshots hold arrays.

The reference's ``TraceGuard`` counts jax traces and compiles through
jax's compile logging; the port compiles nothing at run time, so it has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["DeterminismError", "seeded_replay_check", "diff_snapshots"]


class DeterminismError(AssertionError):
    """Raised when two identically-seeded runs produced different results."""


def _is_nan(x: Any) -> bool:
    return isinstance(x, float) and math.isnan(x)


def diff_snapshots(a: Any, b: Any, path: str = "",
                   out: Optional[List[str]] = None,
                   limit: int = 20) -> List[str]:
    """Recursive NaN-aware structural diff; returns dotted paths that
    differ (empty list == identical)."""
    out = out if out is not None else []
    if len(out) >= limit:
        return out
    where = path or "<root>"
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        if type(a) is not type(b):
            out.append(f"{where}: {type(a).__name__} != {type(b).__name__}")
            return out
        for f in dataclasses.fields(a):
            diff_snapshots(getattr(a, f.name), getattr(b, f.name),
                           f"{path}.{f.name}" if path else f.name, out, limit)
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            out.append(f"{where}: keys {sorted(set(a) ^ set(b))!r} differ")
            return out
        for k in a:
            diff_snapshots(a[k], b[k], f"{path}[{k!r}]", out, limit)
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            out.append(f"{where}: length {len(a)} != {len(b)}")
            return out
        for i, (x, y) in enumerate(zip(a, b)):
            diff_snapshots(x, y, f"{path}[{i}]", out, limit)
        return out
    if _is_nan(a) and _is_nan(b):
        return out
    if hasattr(a, "shape") and hasattr(a, "dtype"):  # ndarray-likes
        try:
            import numpy as np
            if not (hasattr(b, "shape") and a.shape == b.shape
                    and np.array_equal(np.asarray(a), np.asarray(b),
                                       equal_nan=True)):
                out.append(f"{where}: arrays differ")
        except Exception:
            out.append(f"{where}: unorderable array-likes")
        return out
    if a != b:
        out.append(f"{where}: {a!r} != {b!r}")
    return out


def seeded_replay_check(fn: Callable[[int], Any], seed: int = 0, *,
                        runs: int = 2,
                        strict: bool = True) -> Tuple[bool, List[str]]:
    """Run ``fn(seed)`` ``runs`` times and diff the returned snapshots.

    ``fn`` must build its ENTIRE simulation from the seed — any hidden
    wall-clock read or process-global RNG shows up as a diff.  Returns
    ``(ok, diffs)``; with ``strict=True`` (default) raises
    :class:`DeterminismError` on divergence instead.
    """
    if runs < 2:
        raise ValueError("seeded_replay_check needs at least 2 runs")
    snaps = [fn(seed) for _ in range(runs)]
    diffs: List[str] = []
    for i, later in enumerate(snaps[1:], start=2):
        for d in diff_snapshots(snaps[0], later):
            diffs.append(f"run1 vs run{i}: {d}")
    ok = not diffs
    if not ok and strict:
        shown = "\n  ".join(diffs[:20])
        raise DeterminismError(
            f"seeded replay diverged for seed={seed} "
            f"({len(diffs)} difference(s)):\n  {shown}\n"
            "A seeded sim must be a pure function of its seed: a hidden "
            "wall-clock read or global RNG state leaked into it.")
    return ok, diffs
