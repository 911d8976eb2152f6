"""Every piece of a cell is found by name, and a configuration, a mix, a
metric and a cell are added as new files and entries, editing none."""

import json
import shutil
import types

import pytest
import torch

from harness import runner, spec
from tiny import MODELS, TRAFFIC, tiny_cell

BENCH = spec.load_json(spec.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.find_cell(name)
    assert cell.driver().Run
    assert cell.reference().param_specs
    assert cell.limits["numbers"]
    kinds = {m.kind for m in cell.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    assert "setup_s" in [m.name for m in cell.metrics]
    for m in cell.metrics:
        assert callable(cell.reader(m.name).read), m.name
        if m.kind == "per_layer":
            assert m.moves in [e.name for e in cell.metrics if e.kind == "end_to_end"]


def test_config_files_name_their_source():
    for c in BENCH["configs"]:
        f = spec.load_json(spec.CHECKOUT / c["file"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
        assert f["assumed"] and f["reference"]


def _copy(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root


def test_new_metric_is_a_new_file(tmp_path):
    root = _copy(tmp_path)
    (root / "metrics" / "toy_tokens.batch.py").write_text(
        "def read(record):\n    return 2.0 * record.host['tokens']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "toy_tokens.batch", "unit": "tokens", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "batch_tok_s", "workloads": ["granite-8b.batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("granite-8b.batch", root=root)
    assert "toy_tokens.batch" in [m.name for m in cell.metrics]
    assert "toy_tokens.batch" not in [m.name for m in spec.find_cell("granite-8b.docqa",
                                                                     root=root).metrics]
    record = types.SimpleNamespace(host={"tokens": 21})
    assert cell.reader("toy_tokens.batch").read(record) == 42.0


def test_new_config_mix_and_cell_run_from_new_files(tmp_path):
    """A configuration file, a traffic file, a limits file and an entry of
    each list: the new cell runs (tiny, on the CPU) and reports its
    metrics, with no file of the benchmark edited."""
    root = _copy(tmp_path)
    cfg = spec.load_json(root / "configs" / "granite-8b.json")
    cfg["model"].update(MODELS["granite-8b"], n_layers=3, arch_id="toy-dense")
    cfg["name"] = "toy-dense"
    (root / "configs" / "toy-dense.json").write_text(json.dumps(cfg))
    mix = {**spec.load_json(root / "traffic" / "batch.json"), **TRAFFIC["batch"]}
    mix["prompt"] = {"dist": "uniform", "min": 40, "max": 60}
    (root / "traffic" / "short.json").write_text(json.dumps(mix))
    (root / "limits" / "toy-dense.short.json").write_text(json.dumps(
        {"numbers": {"logit_gap": {"limit": 0.1}}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-dense", "source": cfg["source"],
                             "file": "perfbench/configs/toy-dense.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy-dense.short", "config": "toy-dense",
                               "traffic": "short", "chips": 1, "why": "toy"})
    bench["end_to_end"][0]["workloads"].append("toy-dense.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("toy-dense.short", root=root)
    out = runner.run_cell(cell, 11, 3.0, False, torch.device("cpu"), 0.0)
    assert out["correct"] and set(out["metrics"]) == {"batch_tok_s", "setup_s"}
    assert all(40 <= p <= 60 for p, _ in out["host"]["requests"])


def test_tiny_cells_keep_the_real_files():
    for name in CELLS:
        cell = tiny_cell(name)
        assert cell.driver().__name__.startswith("perfbench_driver_")
