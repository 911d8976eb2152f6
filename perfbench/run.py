"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  The cell,
its configuration, traffic, metrics and limits are found by name
(``BENCHMARK.json`` and the files under ``perfbench/``).  Without a CUDA
device, or with fewer than the cell asks for, it exits 2 and prints no
result.  The last line of standard output is the result's JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import runner, spec
    runner.cache_dirs(spec.CHECKOUT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)    # one host thread: no idle workers spinning beside the dispatch
    import repro_torch  # noqa: F401  (the program; absent, the run stops here)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}}
    if args.trace:
        result["device"]["busy_s"] = out["busy_s"]
        result["device"]["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["numbers"] = out["numbers"]
    result["checks"] = out["checks"]
    print(f"bench: {args.workload} seed {args.seed} on {result['device']['kind']}; "
          f"setup done, check {out['check_s']:.1f} s, numbers {json.dumps(out['numbers'])}"
          + (f", trace ops tied to launches {out.get('trace_matched')}" if args.trace else ""),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
