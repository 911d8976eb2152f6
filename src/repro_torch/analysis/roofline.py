"""Three-term roofline from dry-run artifacts (port of
``repro/analysis/roofline.py``).

    compute    = FLOPs_dev / peak_flops
    memory     = HBM_bytes_dev / hbm_bw
    collective = wire_bytes_dev / (link_bw x efficiency)

A cell is one dry-run artifact (:mod:`repro_torch.launch.dryrun`, or the
reference's): its per-device bytes and wire bytes are scaled by the step
builder's multipliers (``layers_multiplier`` x ``accum_multiplier`` x
``tick_multiplier``; unrolled cells by ``accum_multiplier`` alone), and the
compute term is the analytic FLOP model (:mod:`repro_torch.analysis.analytic`).
``MODEL_FLOPS = 6 N_active D`` (2 N D when serving) gives the useful-work
ratio.

The device and the link efficiency are arguments: by default one H100 of a
production mesh and the port's assumed efficiency (``hw/specs.py``,
datasheet figures).  ``chips`` is read from the mesh name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List

from repro_torch.analysis.analytic import flops_per_device
from repro_torch.configs import SHAPES, get_config
from repro_torch.hw.specs import H100_MESH, LINK_EFFICIENCY, DeviceProfile


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    strategy: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    useful_ratio: float = 0.0
    peak_gb: float = 0.0
    step_s: float = 0.0            # max of the three (no-overlap bound)
    note: str = ""

    def fraction_of_roofline(self) -> float:
        """compute_term / step_time: how close the cell is to being
        compute-bound at peak (1.0 = perfectly compute-roofed)."""
        return self.compute_s / self.step_s if self.step_s else 0.0


def _multiplier(meta: dict, unrolled: bool) -> float:
    if unrolled:
        m = meta.get("accum_multiplier", 1) or 1
        return float(m)
    m = float(meta.get("layers_multiplier", 1) or 1)
    m *= float(meta.get("accum_multiplier", 1) or 1)
    m *= float(meta.get("tick_multiplier", 1) or 1) if "tick_multiplier" in meta else 1.0
    return m


def row_from_cell(cell: dict, device: DeviceProfile = H100_MESH,
                  link_efficiency: float = LINK_EFFICIENCY) -> RooflineRow:
    row = RooflineRow(arch=cell["arch"], shape=cell["shape"],
                      mesh=cell["mesh"], strategy=cell.get("strategy", ""),
                      status=cell["status"])
    if cell["status"] == "skip":
        row.note = cell.get("reason", "")[:80]
        return row
    if cell["status"] != "ok":
        row.note = cell.get("error", "")[:80]
        return row
    meta = cell.get("meta", {})
    unrolled = cell.get("unrolled", False)
    mult = _multiplier(meta, unrolled)
    chips = 512 if cell["mesh"] == "pod2x16x16" else 256

    hlo_flops_dev = cell["cost"]["flops_per_device"] * mult
    bytes_dev = cell["cost"]["bytes_accessed_per_device"] * mult
    wire_mult = float(meta["wire_multiplier"]) if "wire_multiplier" in meta \
        else mult
    wire_dev = cell["collectives"]["wire_bytes_per_device"] * wire_mult

    cfg = get_config(cell["arch"])
    shape = SHAPES[cell["shape"]]
    # COMPUTE term: the analytic model (exact matmul accounting)
    pad = int(meta.get("n_pad_layers", 0) or 0)
    flops_dev = flops_per_device(cfg, shape, chips,
                                 remat=shape.kind == "train", pad_layers=pad)

    row.compute_s = flops_dev / device.flops
    row.memory_s = bytes_dev / device.mem_bw
    row.collective_s = wire_dev / (device.link_bw * link_efficiency)
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.step_s = max(terms.values())
    row.peak_gb = cell["memory"]["peak_bytes_per_device"] / 1e9

    n = cfg.active_params()
    row.model_flops = (6.0 if shape.kind == "train" else 2.0) * n \
        * shape.tokens_per_step
    # useful-work ratio: 6ND over the ANALYTIC total (attention/remat/CE
    # overheads push it below 1); the hlo column is kept for cross-checks
    row.hlo_flops_global = hlo_flops_dev * chips
    row.useful_ratio = row.model_flops / (flops_dev * chips)
    return row


def improvement_hint(row: RooflineRow) -> str:
    if row.status != "ok":
        return ""
    if row.dominant == "collective":
        return ("shard activations along seq (reduce-scatter/all-gather "
                "instead of per-layer all-reduce) or move DP traffic off the "
                "critical path (overlap / compress)")
    if row.dominant == "memory":
        if row.shape in ("decode_32k", "long_500k"):
            return ("KV-cache reads dominate: shrink cache dtype (int8 KV), "
                    "raise batch per chip, or flash-decode with wider tiles")
        return ("cut activation traffic: fuse norms/elementwise (Pallas), "
                "lower remat scope, bf16 stash")
    return ("increase per-chip arithmetic intensity: larger microbatch, "
            "fewer pipeline bubbles, avoid remat recompute where HBM allows")


def load_cells(art_dir: Path) -> List[dict]:
    return [json.loads(p.read_text()) for p in sorted(art_dir.glob("*.json"))]


def best_rows(cells: List[dict], device: DeviceProfile = H100_MESH,
              link_efficiency: float = LINK_EFFICIENCY) -> Dict[tuple, RooflineRow]:
    """One row per (arch, shape, mesh): prefer ok cells, then the per-cell
    default strategies (pp_shardmap / gspmd_pp over the gspmd_tp
    baseline)."""
    out: Dict[tuple, RooflineRow] = {}
    pref = {"pp_shardmap": 2, "gspmd_pp": 2, "gspmd_tp": 1, "": 0}
    for cell in cells:
        row = row_from_cell(cell, device, link_efficiency)
        key = (row.arch, row.shape, row.mesh)
        cur = out.get(key)
        if cur is None:
            out[key] = row
            continue
        if (row.status == "ok", pref.get(row.strategy, 0)) > \
           (cur.status == "ok", pref.get(cur.strategy, 0)):
            out[key] = row
    return out
