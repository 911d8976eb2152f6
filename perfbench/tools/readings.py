"""Readings for the limits of ``correct``: the program's compared numbers
over many seeds, the float8 control's on some, and (training) the planted
fault of half the batch, at the cell's own size, in one process.

    python3 perfbench/tools/readings.py --workload <cell> --seconds <s> \\
        --seeds 1,2,... [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

One JSON line a reading on standard output.  The benchmark's runs never
call this; it is how the limits in ``limits/<cell>.json`` were read.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def half_batch(tokens):
    """The fault: the program sees only the first half of each batch, so its
    loss is the mean over the rest."""
    return tokens[: tokens.shape[0] // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    import torch
    from harness import runner, spec
    runner.cache_dirs(spec.CHECKOUT)
    if not torch.cuda.is_available():
        sys.exit("readings need a CUDA device")
    cell = spec.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    control, fault = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    jobs = [(s, "program") for s in ints(args.seeds)] + [(s, "half_batch") for s in sorted(fault)]
    for seed, what in jobs:
        t0 = time.perf_counter()
        hooks = {"batch": half_batch} if what == "half_batch" else None
        out = runner.run_cell(cell, seed, args.seconds, False, dev, t0, hooks=hooks,
                              fp8=what == "program" and seed in control)
        line = {"seed": seed, "run": what, "numbers": out["numbers"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "attempted": out["attempted"], "check_s": out["check_s"],
                "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
