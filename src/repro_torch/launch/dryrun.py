"""Multi-pod dry-run: account every (arch x shape) cell on the production
meshes and record memory / cost / collective artifacts (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell's step for 512 fake XLA host
devices and reads the compiler's memory and cost analyses and the HLO's
collectives.  Torch has nothing that compiles one program for a mesh it
does not have, so the port accounts each cell analytically from the step
builder's own output (:func:`repro_torch.launch.steps.make_step`, built on
``meta``: no weight is drawn, no kernel runs):

* exact: params, gradients, AdamW moments (ZeRO-1 where the strategy
  shards them), batch and cache bytes per device, as sums of the shard
  shapes of the strategy's spec trees (:mod:`repro_torch.core.sharding`)
  over the reference's layout (pipeline pad slots included);
* estimated: activation bytes (the layer inputs remat keeps, or a serving
  step's live rows, plus one layer's working set), HBM bytes accessed and
  collective wire bytes, from the strategy's layout with
  :func:`repro_torch.analysis.hlo.ring_factor`; the artifact lists them
  under ``estimates``;
* FLOPs: the analytic model (:mod:`repro_torch.analysis.analytic`).

Artifacts keep the reference's schema (``status``, ``strategy``,
``memory``, ``cost``, ``collectives``, ``meta``, ``unrolled``), so the
reference's roofline reads them too.  As in the reference, ``cost`` and
``collectives`` hold one scanned body's share -- the step's totals divided
by the multipliers in ``meta`` -- which :func:`repro_torch.analysis.roofline.row_from_cell`
multiplies back (``unrolled``: the reference's choice per arch,
``UNROLL_OK``); ``totals`` holds the step's totals.  Each cell records
whether its peak fits one 80 GB H100 (``fits_h100_80gb``).  Artifacts go to
``build/dryrun/`` under the working directory.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.analytic import flops_per_device
from repro_torch.analysis.hlo import ring_factor
from repro_torch.analysis.roofline import _multiplier
from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig, RunConfig, ShapeConfig,
                                 get_config, get_shape, shape_applicable)
from repro_torch.core import sharding as sh
from repro_torch.hw.specs import H100_MESH
from repro_torch.launch.mesh import dp_degree, make_production_mesh
from repro_torch.launch.steps import _serve_fsdp, make_step, prefill_cache_specs

ART_DIR = Path("build") / "dryrun"

# archs whose layer loop the reference unrolls for exact HLO accounting
# (here only the divisor of ``cost`` / ``collectives``: the totals are equal)
UNROLL_OK = {"granite-8b", "mistral-nemo-12b", "yi-34b", "command-r-35b",
             "whisper-small", "internvl2-1b", "llama4-scout-17b-a16e",
             "grok-1-314b"}

ESTIMATES = ["memory.temp_bytes: activations, one layer's working set",
             "cost.bytes_accessed_per_device", "collectives"]


def _f32(tree):
    return sh.map_with_path(lambda _, t: torch.empty(t.shape, dtype=torch.float32,
                                                     device="meta"), tree)


class _Wire:
    """Collective ops of one step per device: kind -> (count, wire bytes),
    with hlo.py's ring factors over a group of ``n``."""

    def __init__(self):
        self.kinds: dict = {}

    def add(self, op: str, nbytes: float, n: int, count: float = 1) -> None:
        if n <= 1 or count <= 0:
            return
        c, b = self.kinds.get(op, (0, 0.0))
        self.kinds[op] = (c + count, b + count * ring_factor(op, n) * nbytes)

    @property
    def wire(self) -> float:
        return sum(b for _, b in self.kinds.values())

    @property
    def n_ops(self) -> int:
        return int(sum(c for c, _ in self.kinds.values()))


def _param_layout(rcfg: RunConfig, built: dict, mesh, fsdp: bool):
    """(params, params' specs, moments' specs) over the reference's layout
    for the cell's strategy."""
    strategy = built["meta"]["strategy"]
    params = built["args"][0]
    if strategy == "pp_shardmap":
        return sh.pp_shardmap_shardings(params, mesh)
    if strategy == "gspmd_pp":
        ref, p_spec = sh.reference_shardings(params, mesh, "gspmd_pp")
        return ref, p_spec, p_spec
    ref, p_spec = sh.reference_shardings(params, mesh, "gspmd_tp", fsdp=fsdp)
    return ref, p_spec, sh.reference_shardings(params, mesh, "gspmd_tp",
                                               fsdp=rcfg.zero1 or fsdp)[1]


def _layer_io(cfg: ModelConfig) -> int:
    """Activation elements a token holds inside one layer at its widest:
    the residual, the normed input, q/k/v and the attention output, and the
    MLP's (or an expert's) hidden rows (gated: two)."""
    mats = 2 if cfg.glu else 1
    return 4 * cfg.d_model + cfg.q_dim + 2 * cfg.kv_dim + mats * cfg.d_ff


def account(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh, built: dict) -> dict:
    """The cell's memory, totals and collectives per device (see the module
    docstring for what is exact and what is estimated)."""
    meta = built["meta"]
    strategy = meta["strategy"]
    cbytes = 2 if rcfg.compute_dtype == "bfloat16" else 4
    tp = mesh.shape["model"]
    dp = dp_degree(mesh)
    chips = mesh.size
    train = shape.kind == "train"
    fsdp = meta.get("fsdp", False) if train else _serve_fsdp(cfg, mesh)
    ref, p_spec, m_spec = _param_layout(rcfg, built, mesh, fsdp)
    params_dev = sh.shard_bytes(ref, p_spec, mesh)
    wire = _Wire()
    n_layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    # the layers this device runs, and the tokens a layer sees per pass
    if strategy == "gspmd_pp":
        layers_dev, passes = meta["layers_per_stage"], meta["M"]
        tok_pass = shape.global_batch // passes // mesh.shape.get("pod", 1) * shape.seq_len
    elif strategy == "pp_shardmap":
        g = built["geometry"]
        layers_dev, passes = g.lps, g.M
        tok_pass = g.b_mb * shape.seq_len
    else:
        accum = meta.get("accum", 1)
        layers_dev, passes = n_layers, accum
        tok_pass = max(1, shape.global_batch // dp // accum) * (
            shape.seq_len if shape.kind != "decode" else 1)
    act_row = tok_pass * cfg.d_model * cbytes                      # one layer input
    fwd_passes = (2 if rcfg.remat else 1) if train else 1            # remat re-runs forward
    mem = {}
    if train:
        gdt_bytes = 4 if strategy == "gspmd_tp" and meta.get("accum", 1) > 1 else cbytes
        grads_dev = params_dev * gdt_bytes // cbytes
        moments_dev = 2 * sh.shard_bytes(_f32(ref), m_spec, mesh)
        batch_dev = sh.shard_bytes(built["args"][2], built["in_shardings"][2], mesh)
        # remat keeps each layer's input for every pass in flight (GPipe:
        # every microbatch), plus one layer's working set
        stash = layers_dev * act_row * (passes if strategy != "gspmd_tp" else 1)
        work = tok_pass * _layer_io(cfg) * cbytes // (tp if strategy != "pp_shardmap" else 1)
        temp = grads_dev + stash + 2 * work
        args = params_dev + moments_dev + batch_dev
        mem = {"argument_bytes": args, "output_bytes": params_dev + moments_dev,
               "temp_bytes": temp, "alias_bytes": params_dev + moments_dev}
        # HBM traffic: weights read per forward, remat forward and backward
        # pass of each microbatch; gradients accumulated; AdamW reads p, g, m,
        # v and writes p, m, v; activations written and read twice
        bytes_acc = (params_dev * (fwd_passes + 1) * passes + 2 * grads_dev * passes
                     + 3 * params_dev + grads_dev + 2 * moments_dev
                     + 3 * stash + 4 * work * layers_dev * passes)
        grad_bytes = params_dev * gdt_bytes // cbytes
        if strategy == "gspmd_tp":
            # Megatron TP: two all-reduces a layer per forward, two per backward
            wire.add("all-reduce", act_row, tp, 2 * (fwd_passes + 1) * n_layers * passes)
            if fsdp:       # params gathered for each forward and backward pass
                wire.add("all-gather", params_dev * dp, dp, (fwd_passes + 1) * passes)
                wire.add("reduce-scatter", grad_bytes, dp, passes)
            else:          # ZeRO-1: grads reduce-scattered, params gathered back
                wire.add("reduce-scatter", grad_bytes / dp, dp, 1)
                wire.add("all-gather", params_dev, dp, 1)
        elif strategy == "gspmd_pp":
            ticks = meta["tick_multiplier"]
            wire.add("collective-permute", act_row, 2, (fwd_passes + 1) * ticks)
            wire.add("all-reduce", act_row, tp, 2 * (fwd_passes + 1) * layers_dev * passes)
            wire.add("all-reduce", grad_bytes, mesh.shape.get("pod", 1), 1)
        else:
            wire.add("collective-permute", act_row, 2, meta["wire_multiplier"])
            wire.add("all-reduce", grad_bytes, dp, 1)
        if cfg.n_experts:   # expert dispatch and combine, forward and backward
            routed = tok_pass * cfg.top_k * cfg.d_model * cbytes
            wire.add("all-to-all", routed, tp,
                     2 * (fwd_passes + 1) * layers_dev * passes)
    else:
        cache_dev = 0
        if shape.kind == "decode":
            cache_dev = sh.shard_bytes(built["args"][1], built["in_shardings"][1], mesh)
            batch_dev = sh.shard_bytes(built["args"][2], built["in_shardings"][2], mesh)
        else:
            batch_dev = sh.shard_bytes(built["args"][1], built["in_shardings"][1], mesh)
            cache = prefill_cache_specs(built["model"], shape)
            cache_dev = sh.shard_bytes(cache, built["out_shardings"][1], mesh)
        work = tok_pass * _layer_io(cfg) * cbytes // tp
        args = params_dev + batch_dev + (cache_dev if shape.kind == "decode" else 0)
        out = cache_dev
        mem = {"argument_bytes": args, "output_bytes": out, "temp_bytes": 2 * work,
               "alias_bytes": cache_dev if shape.kind == "decode" else 0}
        bytes_acc = params_dev + 2 * cache_dev + 4 * work * n_layers
        wire.add("all-reduce", act_row, tp, 2 * n_layers)
        if fsdp:
            wire.add("all-gather", params_dev * dp, dp, 1)
        if cfg.n_experts:
            wire.add("all-to-all", tok_pass * cfg.top_k * cfg.d_model * cbytes, tp,
                     2 * n_layers)
    mem["peak_bytes_per_device"] = (mem["argument_bytes"] + mem["temp_bytes"]
                                    + mem["output_bytes"] - mem["alias_bytes"])
    pad = int(meta.get("n_pad_layers", 0) or 0)
    flops = flops_per_device(cfg, shape, chips, remat=train, pad_layers=pad)
    return {"memory": mem, "flops": flops, "bytes_accessed": float(bytes_acc), "wire": wire,
            "params_bytes_per_device": params_dev}


def run_cell(arch: str, shape_name: str, multi_pod: bool, strategy: str = None,
             out_dir: Path = ART_DIR, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        cell.update(status="skip", reason=why)
        _save(cell, out_dir)
        return cell
    mesh = make_production_mesh(multi_pod=multi_pod)
    unroll = arch in UNROLL_OK
    rcfg = RunConfig(unroll_layers=unroll)
    t0 = time.perf_counter()
    try:
        built = make_step(cfg, shape, rcfg, mesh, strategy=strategy, device="meta")
        meta = built["meta"]
        cell["strategy"] = meta["strategy"]
        acc = account(cfg, shape, rcfg, mesh, built)
        mult = _multiplier(meta, unroll)
        wire_mult = float(meta.get("wire_multiplier", mult))
        wire = acc["wire"]
        cell.update(
            status="ok",
            unrolled=unroll,
            account_s=round(time.perf_counter() - t0, 3),
            memory=acc["memory"],
            cost={"flops_per_device": acc["flops"] / mult,
                  "bytes_accessed_per_device": acc["bytes_accessed"] / mult},
            collectives={
                "wire_bytes_per_device": wire.wire / wire_mult,
                "payload_bytes_per_device": sum(b for _, b in wire.kinds.values()) / wire_mult,
                "by_kind": {k: {"count": c, "wire_bytes": b / wire_mult}
                            for k, (c, b) in wire.kinds.items()},
                "n_ops": wire.n_ops,
            },
            totals={"flops_per_device": acc["flops"],
                    "bytes_accessed_per_device": acc["bytes_accessed"],
                    "wire_bytes_per_device": wire.wire,
                    "params_bytes_per_device": acc["params_bytes_per_device"]},
            fits_h100_80gb=acc["memory"]["peak_bytes_per_device"] <= H100_MESH.mem_bytes,
            estimates=ESTIMATES,
            meta=meta,
        )
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({cell['strategy']}): "
                  f"peak/dev {acc['memory']['peak_bytes_per_device'] / 1e9:.2f} GB "
                  f"({'fits' if cell['fits_h100_80gb'] else 'exceeds'} 80 GB), "
                  f"{acc['flops'] / 1e9:.1f} GFLOP/dev, {wire.wire / 1e6:.1f} MB wire/dev "
                  f"(estimate, {wire.n_ops} collective ops)")
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED -- {e}")
    _save(cell, out_dir)
    return cell


def _save(cell: dict, out_dir: Path) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    parts = [cell["arch"], cell["shape"], cell["mesh"]]
    if cell.get("strategy"):
        parts.append(cell["strategy"])
    (out_dir / ("__".join(parts) + ".json")).write_text(json.dumps(cell, indent=1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--all", action="store_true", help="every arch and shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--strategy", default=None,
                    choices=[None, "pp_shardmap", "gspmd_tp", "gspmd_pp"])
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [run_cell(a, s, mp, strategy=args.strategy, out_dir=Path(args.out),
                      verbose=not args.quiet)
             for a in archs for s in shapes for mp in meshes]
    n = {st: sum(c["status"] == st for c in cells) for st in ("ok", "error", "skip")}
    print(f"[dryrun] done: {n['ok']} ok, {n['error']} failed, {n['skip']} skipped")
    if n["error"]:
        raise SystemExit(1)
    return {"cells": cells}


if __name__ == "__main__":
    main()
