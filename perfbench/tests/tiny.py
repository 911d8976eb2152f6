"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
CPU tests: the same files, drivers, readers and limits, with every width,
the engine and the traffic made small."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

MODELS = {
    "granite-8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=512),
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=224,
                       vocab_size=512),
}
TRAFFIC = {
    "batch": dict(engine={"backend": "dense", "max_batch": 4, "max_len": 128}, requests=64,
                  block=8, prompt={"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8,
                                   "max": 64},
                  max_new={"dist": "loguniform", "min": 4, "max": 32},
                  check={"served_tokens": 32, "requests": 2}),
    "docqa": dict(engine={"backend": "dense", "max_batch": 4, "max_len": 256}, requests=64,
                  block=8, prompt={"dist": "uniform", "min": 64, "max": 192},
                  max_new={"dist": "uniform", "min": 2, "max": 8},
                  check={"served_tokens": 16, "requests": 2}),
    "train": dict(batch=2, seq=32),
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    config = copy.deepcopy(cell.config)
    config["model"].update(MODELS[cell.config_name])
    traffic = {**copy.deepcopy(cell.traffic), **TRAFFIC[cell.traffic_name]}
    return dataclasses.replace(cell, config=config, traffic=traffic)
