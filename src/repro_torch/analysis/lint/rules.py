"""The port's repro-lint rules (port of ``repro/analysis/lint/rules.py``).

=====  =====================================================================
R002   no wall-clock in sim-clock modules: one ``time.sleep`` in a sim path
       breaks the never-sleep contract; engines pace by ``engine.clock``.
R004   no implicit host sync (``.item()``, ``.tolist()``, ``.cpu()``,
       ``int()/float()/bool()`` on a variable) inside ``*step*`` hot-path
       functions of a torch module: each one waits for the device.
R005   anything calling itself an Engine/Backend must statically define the
       protocol's required attributes (fleet code duck-types against them).
R006   frozen snapshots (EngineSnapshot/FleetSnapshot/ScaleSnapshot/...)
       are immutable outside their defining module: consumers fork with
       ``dataclasses.replace``, never mutate.
=====  =====================================================================

The reference's R001 (shared ``jax.jit`` wrappers) and R003 (PRNG key
discipline) check jax idioms the port has no counterpart of: it compiles
nothing at run time and draws from ``torch.Generator``s.  The rule ids
stay the reference's.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from repro_torch.analysis.lint.core import ClassInfo, FileContext, Violation, rule

# ---------------------------------------------------------------------------
# Shared configuration (kept here, dependency-free, so the linter runs
# without torch; tests pin these against the runtime definitions).
# ---------------------------------------------------------------------------

#: module-path fragments whose code runs under a swappable sim clock.
SIM_CLOCK_SCOPES = (
    "repro_torch/serving/",
    "repro_torch/runtime/elastic.py",
    "repro_torch/runtime/monitor.py",
    "repro_torch/runtime/trainer.py",  # clock= injected; fed rounds run on sim time
    "repro_torch/offload/tools.py",    # tool-loop async path; allowlisted for R002
)

#: wall-clock calls banned inside sim-clock scopes.  ``time.perf_counter``
#: is deliberately NOT here: it is the default wall clock engines are
#: constructed with and the telemetry stamp -- the ban is on *pacing* by
#: wall time (sleep) and on non-injectable time/randomness sources.
WALL_CLOCK_BANNED = {
    "time.time": "wall-clock read; pace by engine.clock instead",
    "time.sleep": "sim-clock paths must never sleep; advance the SimClock",
    "datetime.datetime.now": "wall-clock read; pace by engine.clock instead",
    "datetime.datetime.utcnow": "wall-clock read; pace by engine.clock instead",
    "datetime.datetime.today": "wall-clock read; pace by engine.clock instead",
    "datetime.date.today": "wall-clock read; pace by engine.clock instead",
}

#: mirror of ``repro_torch.serving.engine_api.REQUIRED_ATTRS`` (pinned by test).
ENGINE_REQUIRED_ATTRS = ("scheduler", "slots", "finished", "max_batch",
                         "metrics")

#: mirror of ``repro_torch.serving.backends.CacheBackend.REQUIRED_ATTRS``.
BACKEND_REQUIRED_ATTRS = ("name", "n_blocks", "state_version",
                          "snapshot_free")

#: frozen snapshot dataclasses and the modules allowed to touch their guts.
SNAPSHOT_CLASSES = {
    "EngineSnapshot", "FleetSnapshot", "ScaleSnapshot", "WorkerSnapshot",
    "GroupSnapshot", "SpecSnapshot", "SLOReport", "ClassSLOReport",
    "FedRoundSnapshot",
}
SNAPSHOT_METHODS = {"snapshot", "metrics_snapshot"}
SNAPSHOT_DEFINING_MODULES = (
    "repro_torch/serving/metrics.py",
    "repro_torch/serving/fleet.py",
    "repro_torch/serving/scale.py",
    "repro_torch/serving/train_plane.py",
)


def _in_scope(ctx: FileContext, scopes) -> bool:
    return any(frag in ctx.module if frag.endswith("/")
               else ctx.module.endswith(frag) for frag in scopes)


# ---------------------------------------------------------------------------
# R002 -- never-sleep / no wall clock in sim modules
# ---------------------------------------------------------------------------


@rule("R002", "no wall-clock (time.time/sleep, datetime.now, random) in "
              "sim-clock modules")
def r002_no_wall_clock(ctx: FileContext) -> Iterator[Violation]:
    if not _in_scope(ctx, SIM_CLOCK_SCOPES):
        return
    seen: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Attribute, ast.Name)):
            continue
        # skip attribute sub-chains so `time.sleep` reports once
        parent = getattr(node, "_repro_parent", None)
        if isinstance(parent, ast.Attribute):
            continue
        dn = ctx.dotted(node)
        if dn is None:
            continue
        why = WALL_CLOCK_BANNED.get(dn)
        if why is None and (dn == "random" or dn.startswith("random.")):
            why = ("stdlib random is process-global and unseedable per "
                   "lane; use a seeded numpy Generator or torch.Generator")
        if why is None:
            continue
        if node.lineno in seen:
            continue
        seen.add(node.lineno)
        yield Violation(
            "R002", ctx.path, node.lineno, node.col_offset,
            f"`{dn}` in a sim-clock module: {why} (the never-sleep "
            "contract).")


# ---------------------------------------------------------------------------
# R004 -- no implicit host sync in hot-path *step* functions
# ---------------------------------------------------------------------------

_CASTS = {"int", "float", "bool"}
_SYNC_METHODS = {"item": "blocks on a device->host roundtrip",
                 "tolist": "copies the tensor to the host",
                 "cpu": "copies the tensor to the host"}


@rule("R004", "no implicit host sync (.item(), .tolist(), .cpu(), "
              "int()/float()/bool()) in *step* hot paths")
def r004_no_host_sync(ctx: FileContext) -> Iterator[Violation]:
    if not ctx.imports_torch:
        return  # torch-free modules have no device tensors to sync
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "step" not in fn.name.lower():
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args
                    and not node.keywords):
                yield Violation(
                    "R004", ctx.path, node.lineno, node.col_offset,
                    f"`.{node.func.attr}()` inside hot-path `{fn.name}`: it "
                    f"{_SYNC_METHODS[node.func.attr]} and stalls the step. "
                    "Batch the transfer (one per step, outside the lane "
                    "loop), keep the value on the device, or pragma the "
                    "deliberate sync point.")
                continue
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _CASTS
                    and node.func.id not in ctx.aliases
                    and len(node.args) == 1
                    and isinstance(node.args[0],
                                   (ast.Name, ast.Attribute, ast.Subscript))):
                yield Violation(
                    "R004", ctx.path, node.lineno, node.col_offset,
                    f"`{node.func.id}(...)` on a variable inside hot-path "
                    f"`{fn.name}`: casting a device tensor is an implicit "
                    "host sync. Use `.tolist()` once per step, or pragma "
                    "the deliberate sync point.")


# ---------------------------------------------------------------------------
# R005 -- Engine/Backend classes must define the protocol attrs
# ---------------------------------------------------------------------------


def _resolved_attrs(index: Dict[str, ClassInfo], name: str,
                    seen: Optional[Set[str]] = None):
    """(attrs, fully_resolved) walking the base chain through the index."""
    seen = seen or set()
    if name in seen:
        return set(), True
    seen.add(name)
    info = index.get(name)
    if info is None:
        return set(), name == "object"
    attrs = set(info.attrs)
    resolved = True
    for base in info.bases:
        if base in ("object", "Protocol", "Generic", "ABC"):
            continue
        sub, ok = _resolved_attrs(index, base, seen)
        attrs |= sub
        resolved = resolved and ok
    return attrs, resolved


@rule("R005", "Engine/Backend classes must statically define the "
              "protocol's REQUIRED_ATTRS")
def r005_protocol_attrs(ctx: FileContext) -> Iterator[Violation]:
    index: Dict[str, ClassInfo] = getattr(ctx, "index", {})
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = index.get(node.name)
        if info is None or info.is_protocol:
            continue
        claims = None
        if node.name.endswith("Engine"):
            claims, required = "DecodeEngine", ENGINE_REQUIRED_ATTRS
        elif node.name.endswith("Backend"):
            claims, required = "CacheBackend", BACKEND_REQUIRED_ATTRS
        if claims is None:
            continue
        attrs, resolved = _resolved_attrs(index, node.name)
        if not resolved:
            continue  # opaque external base: cannot prove either way
        missing = [a for a in required if a not in attrs]
        if missing:
            yield Violation(
                "R005", ctx.path, node.lineno, node.col_offset,
                f"class `{node.name}` claims the {claims} protocol but "
                f"never defines {missing}: fleet code duck-types against "
                f"REQUIRED_ATTRS and will fail at routing time, not "
                "construction time. Define them in __init__ or at class "
                "level.")


# ---------------------------------------------------------------------------
# R006 -- frozen snapshots are immutable outside their defining module
# ---------------------------------------------------------------------------


def _snapshot_sources(ctx: FileContext, value: ast.AST) -> bool:
    """True if `value` constructs a snapshot or calls a .snapshot() method."""
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    if isinstance(fn, ast.Name) and fn.id in SNAPSHOT_CLASSES:
        return True
    if isinstance(fn, ast.Attribute):
        if fn.attr in SNAPSHOT_CLASSES or fn.attr in SNAPSHOT_METHODS:
            return True
    return False


@rule("R006", "frozen snapshot dataclasses are immutable outside their "
              "defining module")
def r006_snapshot_immutable(ctx: FileContext) -> Iterator[Violation]:
    if any(ctx.module.endswith(m) for m in SNAPSHOT_DEFINING_MODULES):
        return
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            continue
        body = fn.body if not isinstance(fn, ast.Module) else [
            s for s in fn.body
            if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))]
        tracked: Set[str] = set()
        for stmt in body if isinstance(fn, ast.Module) else ast.walk(fn):
            if isinstance(stmt, ast.Assign) and _snapshot_sources(
                    ctx, stmt.value):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        tracked.add(tgt.id)
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for tgt in targets:
                    if not isinstance(tgt, ast.Attribute):
                        continue
                    hit = (isinstance(tgt.value, ast.Name)
                           and tgt.value.id in tracked) or \
                        _snapshot_sources(ctx, tgt.value)
                    if hit:
                        yield Violation(
                            "R006", ctx.path, stmt.lineno, stmt.col_offset,
                            f"mutating snapshot field `.{tgt.attr}`: "
                            "snapshots are frozen telemetry records shared "
                            "across consumers; fork with "
                            "`dataclasses.replace(snap, ...)` instead.")
            # only the Expr wrapper, not the Call it contains: ast.walk
            # visits both and matching either would double-report
            call = stmt.value if (isinstance(stmt, ast.Expr)
                                  and isinstance(stmt.value, ast.Call)) \
                else None
            if call is not None:
                dn = ctx.dotted(call.func)
                if dn == "object.__setattr__" and call.args and \
                        isinstance(call.args[0], ast.Name) and \
                        call.args[0].id in tracked:
                    yield Violation(
                        "R006", ctx.path, stmt.lineno, stmt.col_offset,
                        "`object.__setattr__` on a frozen snapshot "
                        "outside its defining module: fork with "
                        "`dataclasses.replace` instead.")
