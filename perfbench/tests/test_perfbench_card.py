"""On the card: each cell through the command line, briefly, comes out
correct with every metric it reports; the float8 control, put in the
program's place at the cell's own size, comes out not correct.  Run with
``python -m pytest -m cuda perfbench/tests/test_perfbench_card.py``."""

import json
import subprocess
import sys
import time

import pytest

from harness import runner, spec

BENCH = spec.load_json(spec.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, name, trace):
    out = subprocess.run([sys.executable, str(spec.ROOT / "run.py"), "--workload", name,
                          "--seed", str(2**31 + 77), "--seconds", "8", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=spec.CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m.name for m in spec.find_cell(name).metrics if m.kind == kind}
    assert want <= set(res["metrics"]) | ({"launches_per_step.batch"} if trace else set())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(card, name):
    cell = spec.find_cell(name)
    out = runner.run_cell(cell, 2**31 + 78, 8.0, False, card, time.perf_counter(), fp8=True)
    assert not out["correct"], out["checks"]
