"""The port's repro-lint: paired good/bad fixtures for each rule it carries
(R002, R004 in its torch forms, R005, R006, mirroring
``tests/test_lint.py``), the port's tree and strict CLI run clean, and the
rule tables pinned to the port's runtime definitions.  Pure stdlib on the
linter side: no jax here."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from textwrap import dedent

import pytest

from repro_torch.analysis.lint import (BACKEND_REQUIRED_ATTRS, ENGINE_REQUIRED_ATTRS, RULES,
                                       SIM_CLOCK_SCOPES, lint_paths, lint_source)
from repro_torch.analysis.lint import rules as lint_rules
from repro_torch.analysis.lint.cli import run as lint_cli_run

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"

#: a fixture module path inside R002's sim-clock scope
SIM_MOD = "repro_torch/serving/fixture.py"


def test_rule_catalogue_is_the_ports():
    """R001 (jit wrappers) and R003 (PRNG keys) check jax idioms and are not
    carried; the ids of the rest are the reference's."""
    assert sorted(RULES) == ["R002", "R004", "R005", "R006"]


# --- R002 ---------------------------------------------------------------------

def test_r002_flags_wall_clock_in_sim_scope():
    bad = dedent("""
        import time
        import random
        from datetime import datetime
        def pace(engine):
            time.sleep(0.1)
            t = time.time()
            r = random.random()
            d = datetime.now()
    """)
    vs = lint_source(bad, module=SIM_MOD, rules=["R002"])
    assert len(vs) == 4


def test_r002_ignores_out_of_scope_and_perf_counter():
    code = dedent("""
        import time
        def pace():
            time.sleep(0.1)
    """)
    assert lint_source(code, module="repro_torch/launch/fixture.py", rules=["R002"]) == []
    good = dedent("""
        import time
        def stamp():
            return time.perf_counter()
    """)
    assert lint_source(good, module=SIM_MOD, rules=["R002"]) == []


def test_r002_pragma_needs_a_reason():
    with_reason = dedent("""
        import time
        def pace():
            time.sleep(0.1)  # repro-lint: allow[R002] wall engines nap for real
    """)
    assert lint_source(with_reason, module=SIM_MOD, rules=["R002"]) == []
    without_reason = with_reason.replace(" wall engines nap for real", "")
    vs = lint_source(without_reason, module=SIM_MOD, rules=["R002"])
    assert len(vs) == 1 and "missing a reason" in vs[0].message


def test_r002_tool_loop_async_path_is_allowlisted():
    code = dedent("""
        import time
        def tool_call():
            time.sleep(0.05)
    """)
    assert lint_source(code, module="repro_torch/offload/tools.py", rules=["R002"]) == []
    assert lint_source(code, module="repro_torch/serving/tools.py", rules=["R002"]) != []


# --- R004 (torch forms) ----------------------------------------------------------

def test_r004_flags_item_tolist_cpu_and_casts_in_step():
    bad = dedent("""
        import torch
        def decode_step(logits, nxt):
            x = logits.item()
            toks = nxt.tolist()
            host = logits.cpu()
            tok = int(nxt[0])
            p = float(logits)
            ok = bool(self.flag)
            return x, toks, host, tok, p, ok
    """)
    vs = lint_source(bad, rules=["R004"])
    assert len(vs) == 6
    assert {v.message.split("`")[1] for v in vs} == {".item()", ".tolist()", ".cpu()",
                                                     "int(...)", "float(...)", "bool(...)"}


def test_r004_ignores_non_step_functions_and_torch_free_modules():
    code = dedent("""
        import torch
        def finalize(logits):
            return logits.item(), logits.tolist()
    """)
    assert lint_source(code, rules=["R004"]) == []
    torch_free = dedent("""
        def on_step(x):
            return int(x), x.item()
    """)
    assert lint_source(torch_free, rules=["R004"]) == []


def test_r004_allows_literals_calls_and_device_moves():
    good = dedent("""
        import torch
        def step(slots, x, n):
            active = int(3.0)
            width = int(len(slots))
            y = x.cpu(non_blocking=True)
            z = x.to("cuda")
            return active, width, y, z
    """)
    assert lint_source(good, rules=["R004"]) == []


def test_r004_pragma_marks_a_deliberate_sync():
    code = dedent("""
        import torch
        def step(sampler, logits):
            # repro-lint: allow[R004] the step's one batched transfer to the host sampler
            return sampler.sample(logits).tolist()
    """)
    assert lint_source(code, rules=["R004"]) == []
    bare = code.replace(" the step's one batched transfer to the host sampler", "")
    vs = lint_source(bare, rules=["R004"])
    assert len(vs) == 1 and "missing a reason" in vs[0].message


# --- R005 ---------------------------------------------------------------------

def test_r005_flags_engine_missing_required_attrs():
    bad = dedent("""
        class BrokenEngine:
            def __init__(self):
                self.slots = []
    """)
    vs = lint_source(bad, rules=["R005"])
    assert len(vs) == 1
    for attr in ("scheduler", "finished", "max_batch", "metrics"):
        assert attr in vs[0].message


def test_r005_passes_complete_engine_and_inherited_backend():
    good = dedent("""
        class GoodEngine:
            def __init__(self):
                self.scheduler = None
                self.slots = []
                self.finished = []
                self.max_batch = 4
                self.metrics = None

        class BaseBackend:
            name = "base"
            n_blocks = 0
            state_version = 0
            snapshot_free = False

        class ChildBackend(BaseBackend):
            name = "child"
    """)
    assert lint_source(good, rules=["R005"]) == []


def test_r005_mirrors_runtime_required_attrs():
    from repro_torch.serving.backends import CacheBackend
    from repro_torch.serving.engine_api import REQUIRED_ATTRS
    assert tuple(ENGINE_REQUIRED_ATTRS) == tuple(REQUIRED_ATTRS)
    assert tuple(BACKEND_REQUIRED_ATTRS) == tuple(CacheBackend.REQUIRED_ATTRS)


# --- R006 ---------------------------------------------------------------------

def test_r006_flags_snapshot_mutation():
    bad = dedent("""
        def tamper(engine):
            snap = engine.metrics_snapshot()
            snap.completed = 0
            return snap
    """)
    vs = lint_source(bad, module="repro_torch/launch/fixture.py", rules=["R006"])
    assert len(vs) == 1 and "replace" in vs[0].message


def test_r006_allows_replace_and_defining_module():
    good = dedent("""
        import dataclasses
        def redact(engine):
            snap = engine.metrics_snapshot()
            return dataclasses.replace(snap, completed=0)
    """)
    assert lint_source(good, module="repro_torch/launch/fixture.py", rules=["R006"]) == []
    mutate = dedent("""
        def fixup(engine):
            snap = engine.metrics_snapshot()
            snap.completed = 0
    """)
    assert lint_source(mutate, module="repro_torch/serving/metrics.py", rules=["R006"]) == []


def test_r006_flags_object_setattr_on_snapshot():
    bad = dedent("""
        def tamper(f):
            snap = FleetSnapshot(sim_t=0.0)
            object.__setattr__(snap, "completed", 9)
    """)
    vs = lint_source(bad, module="repro_torch/launch/fixture.py", rules=["R006"])
    assert len(vs) == 1


# --- the tables against the port's runtime --------------------------------------

def _classes_in(paths):
    out = {}
    for p in paths:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ClassDef):
                out[node.name] = p
    return out


def test_tables_are_pinned_to_the_port():
    """Every sim-clock scope and snapshot-defining module exists in the
    port, and every snapshot class is defined in one of those modules."""
    for frag in SIM_CLOCK_SCOPES + lint_rules.SNAPSHOT_DEFINING_MODULES:
        assert (SRC.parent / frag).exists(), frag
    defining = [SRC.parent / m for m in lint_rules.SNAPSHOT_DEFINING_MODULES]
    classes = _classes_in(defining)
    assert lint_rules.SNAPSHOT_CLASSES <= set(classes), lint_rules.SNAPSHOT_CLASSES - set(classes)
    from repro_torch.analysis.lint.core import FILE_ALLOWLIST
    for suffix, _ in FILE_ALLOWLIST:
        assert (SRC.parent / suffix).exists(), suffix


# --- the port itself is clean ----------------------------------------------------

def test_port_lints_clean():
    violations = lint_paths([SRC])
    assert violations == [], "\n".join(v.format() for v in violations)


def test_cli_strict_run_is_clean(capsys):
    assert lint_cli_run(["--strict", str(SRC)]) == 0
    assert "0 violation(s)" in capsys.readouterr().out


def test_module_entry_point_runs_strict():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--strict"],
                         env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "repro-lint: 0 violation(s)" in run.stdout
    listed = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--list-rules"],
                            env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert [line.split()[0] for line in listed.stdout.splitlines()
            if line.startswith("R")] == ["R002", "R004", "R005", "R006"]


@pytest.mark.parametrize("rule", ["R002", "R004"])
def test_deliberate_exemptions_in_the_port_carry_reasons(rule):
    """Every pragma in the port names its reason (a pragma without one does
    not suppress, so the clean run above already implies it; this lists
    them so an exemption cannot hide)."""
    found = []
    for p in sorted(SRC.rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if f"repro-lint: allow[{rule}]" in line:
                reason = line.split(f"allow[{rule}]", 1)[1].strip()
                assert len(reason) > 10, (p, i)
                found.append(p.name)
    assert found
