"""The program's split of a traced run, and what its spans cost the host.

    python3 perfbench/tools/spans.py split --workload <cell> --seed <n> --seconds <s>
    python3 perfbench/tools/spans.py cost [--backward-spans 73] [--reps 20000]

``split`` runs one cell traced, as ``run.py --trace 1`` does, and prints
one JSON line: the cell's per-layer metrics; the traced slice's idle
seconds by the innermost program span at each gap's middle, over the
slice and inside the benchmark's ``bench.step.*`` spans; the engine's
phase counters as host ms a step; the share of ``engine.step``'s host
time its phases cover; the traced steps' host ms against the untraced
ones'; and each program span's entries a traced step.

``cost`` times on this host what the spans add while no profiler records:
a decode step's phases (``engine.step`` and the seven it holds when
nothing is admitted, through ``MetricsCollector.phase``) and a training
step's spans (``train.*`` and ``--backward-spans`` kernel backward spans),
each through the program's helper and through a stub that does nothing,
beside an unguarded ``record_function`` a span.  The benchmark's runs
never call this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

_NULL = contextlib.nullcontext()


def split(args) -> dict:
    import torch
    from harness import program, runner, spec, trace
    from harness.yardstick import merged_length
    runner.cache_dirs(spec.CHECKOUT)
    kept = {}

    class Keep(trace.Tracer):
        def collect(self):
            super().collect()
            kept["trace"] = self.trace
    runner.Tracer = Keep
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    out = runner.run_cell(spec.find_cell(args.workload), args.seed, args.seconds, True, dev,
                          time.perf_counter())
    tr, host = kept["trace"], out["host"]
    by = program.idle_by_span(tr)
    inside = program.idle_by_span(tr, within="bench.step.")
    idle_in = sum(inside.values())
    line = {"cell": args.workload, "seed": args.seed, "correct": out["correct"],
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "busy_s": tr.busy_s, "window_s": tr.window_s, "idle_s": sum(by.values()),
            "busy_s_less_span_copies": merged_length(
                [(max(s, tr.start), min(e, tr.end)) for _, s, e, _ in program.device_ops(tr)
                 if e > tr.start and s < tr.end]) / 1e9,
            "device_ops": out["breakdown"]["device_ops"][:6],
            "idle_by_span": {str(k): v for k, v in sorted(by.items(), key=lambda x: -x[1])},
            "idle_in_steps_s": idle_in,
            "idle_in_steps_by_span": {str(k): v for k, v in
                                      sorted(inside.items(), key=lambda x: -x[1])},
            "idle_in_steps_to_an_engine_span": (sum(v for k, v in inside.items() if k)
                                                / idle_in if idle_in else None),
            "idle_in_steps_to_a_phase": (sum(v for k, v in inside.items()
                                             if k and k != "engine.step")
                                         / idle_in if idle_in else None)}
    names = sorted({n for n, _, _ in tr.spans if not n.startswith("bench.")})
    if isinstance(host["steps"], list):
        ph = (host["snapshot"] or {}).get("phases") or {}
        n = ph["engine.step"]["calls"] if ph else 0
        if n:
            line["phase_ms_a_step"] = {k: 1e3 * v["seconds"] / n for k, v in ph.items()}
            line["phase_calls"] = {k: v["calls"] for k, v in ph.items()}
            top = ("engine.prepare", "engine.admit", "engine.decode", "engine.sample",
                   "engine.retire")
            line["phases_cover_step"] = (sum(ph[k]["seconds"] for k in top)
                                         / ph["engine.step"]["seconds"])
        steps = {}
        for s in host["steps"]:
            label = s.label + (".traced" if s.traced else "")
            steps.setdefault(label, []).append(s.end - s.start)
        line["step_ms"] = {k: [len(v), 1e3 * statistics.mean(v), 1e3 * statistics.median(v)]
                           for k, v in sorted(steps.items())}
        n_traced = len(tr.named("engine.step"))
    else:
        u = host["untraced"]
        n_traced = host["steps"] - u["steps"]["train.step"]
        line["step_ms"] = {"untraced": 1e3 * u["seconds"] / max(u["steps"]["train.step"], 1),
                           "traced": 1e3 * (host["window_s"] - u["seconds"]) / max(n_traced, 1)}
    line["entries_a_step"] = {k: len(tr.named(k)) / max(n_traced, 1) for k in names}
    return line


def cost(args) -> dict:
    import torch
    from repro_torch.runtime import spans
    from repro_torch.serving.metrics import MetricsCollector

    def decode_step(phase):
        with phase("engine.step"):
            with phase("engine.prepare"):
                pass
            with phase("engine.admit"):
                with phase("engine.schedule"):
                    pass
            with phase("engine.prepare"):
                pass
            with phase("engine.decode"):
                pass
            with phase("engine.sample"):
                pass
            with phase("engine.retire"):
                pass

    def train_step(span):
        for name in ("train.forward", "train.backward", "train.adamw"):
            with span(name):
                pass
        for _ in range(args.backward_spans):
            with span("rwkv6_backward"):
                pass

    def us(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps

    metrics = MetricsCollector(128)
    stub = lambda name, phase=None: _NULL            # noqa: E731
    cases = {"decode_helper": lambda: decode_step(metrics.phase),
             "decode_stub": lambda: decode_step(lambda name: _NULL),
             "train_helper": lambda: train_step(spans.span),
             "train_stub": lambda: train_step(stub),
             "record_function_a_span": lambda: decode_step(torch.profiler.record_function)}
    got = {k: [] for k in cases}
    for _ in range(5):                              # in turns
        for k, fn in cases.items():
            got[k].append(us(fn, args.reps))
    med = {k: statistics.median(v) for k, v in got.items()}
    med["record_function_a_span"] /= 8
    return {"device_host": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
            "backward_spans": args.backward_spans, "median_us": med,
            "decode_step_us": med["decode_helper"] - med["decode_stub"],
            "train_step_us": med["train_helper"] - med["train_stub"], "runs_us": got}


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="what", required=True)
    s = sub.add_parser("split")
    s.add_argument("--workload", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--seconds", type=float, required=True)
    s.add_argument("--device", default="cuda:0")
    c = sub.add_parser("cost")
    c.add_argument("--backward-spans", type=int, default=73)
    c.add_argument("--reps", type=int, default=20000)
    args = ap.parse_args()
    print(json.dumps(split(args) if args.what == "split" else cost(args)), flush=True)


if __name__ == "__main__":
    main()
