"""Discovery: every piece of a cell is found by the name ``BENCHMARK.json``
gives it, as a file of its own.

    configs/<config>.json      sizes, dtype, settings, the reference's name
    traffic/<mix>.json         the mix's parameters and the driver's name
    drivers/<kind>.py          the window of one kind of traffic
    reference/<name>.py        a plain reference
    metrics/<metric>.py        one metric's reader: ``read(run) -> float | None``
    limits/<cell>.json         the limits of the numbers the cell compares

Adding a configuration, a mix, a metric or a cell is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]          # the benchmark's folder
CHECKOUT = ROOT.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str) -> ModuleType:
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str                       # "end_to_end" or "per_layer"
    moves: Optional[str]
    workloads: Optional[List[str]]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    metrics: List[Metric]           # the metrics this cell reports, both kinds
    root: Path

    def reader(self, metric: str):
        return load_file(self.root / "metrics" / f"{metric}.py",
                         "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def reference(self) -> ModuleType:
        return importlib.import_module(f"reference.{self.config['reference']}")

    def driver(self) -> ModuleType:
        return load_file(self.root / "drivers" / f"{self.traffic['kind']}.py",
                         "perfbench_driver_" + self.traffic["kind"])


def metrics_of(bench: Dict, cell: str) -> List[Metric]:
    """The end-to-end metrics that ``cell`` reports (listed for it, or
    listed for no cell), and the per-layer metrics that list it or that,
    listing no cells, move an end-to-end metric it reports."""
    e2e = [Metric(m["name"], m["unit"], "end_to_end", None, m.get("workloads"))
           for m in bench["end_to_end"]]
    e2e = [m for m in e2e if m.workloads is None or cell in m.workloads]
    names = {m.name for m in e2e}
    layer = [Metric(m["name"], m["unit"], "per_layer", m["moves"], m.get("workloads"))
             for m in bench["per_layer"]]
    layer = [m for m in layer if (cell in m.workloads if m.workloads is not None
                                  else m.moves in names)]
    return e2e + layer


def find_cell(name: str, root: Path = ROOT, bench_path: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = load_json(bench_path or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    config = load_json(root / "configs" / f"{w['config']}.json")
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, w["config"], w["traffic"], w["chips"], config, traffic, limits,
                metrics_of(bench, name), root)
