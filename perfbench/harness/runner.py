"""One run of one cell: set-up, the window, the peak memory, then the
program's state freed, the check against the reference, the metric
readers, and the look for JAX in the process."""

from __future__ import annotations

import gc
import os
import sys
import time
import types
from typing import Dict, Optional

import torch

from harness import spec, yardstick
from harness.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(checkout) -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = checkout / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, hooks: Optional[Dict] = None, fp8: bool = False) -> Dict:
    """The result object of one run (without its ``device`` entry), and the
    driver's host record under ``host``.  ``hooks`` plant a fault (the
    readings tool and the tests).  ``fp8`` puts the float8 control in the
    program's place: its numbers (``control_<name>``) are held to the
    limits and decide ``correct``, the program's are kept beside them."""
    driver = cell.driver()
    tracer = Tracer(trace)
    if trace:
        tracer.warm()
    kw = {"hooks": hooks} if hooks else {}
    run = driver.Run(cell, seed, device, tracer, seconds, **kw)
    yardstick.sync()
    gc.collect()
    gc.freeze()         # set-up's objects leave the collector's scans
    setup_s = time.perf_counter() - t_start
    host = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.unfreeze()
    tracer.collect()
    t_check = time.perf_counter()
    numbers = run.check(fp8=fp8)
    check_s = time.perf_counter() - t_check
    record = types.SimpleNamespace(cell=cell, model=cell.config["model"], mix=cell.traffic,
                                   seconds=seconds, setup_s=setup_s, host=host,
                                   trace=tracer.trace, yardstick=yardstick)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m.kind != kind:
            continue
        value = cell.reader(m.name).read(record)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    checks = {}
    for name, lim in cell.limits.get("numbers", {}).items():
        # a number the run could not read (no request finished) is no pass
        key = "control_" + name if fp8 else name
        checks[name] = {"value": float(numbers.get(key, float("nan"))),
                        "limit": float(lim["limit"])}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()) \
        and host["attempted"] > 0
    out = {"correct": correct, "attempted": int(host["attempted"]),
           "failed": int(host["failed"]), "metrics": metrics,
           "memory_peak_bytes": int(peak), "numbers": numbers, "check_s": check_s}
    if tracer.trace is not None:
        out["busy_s"], out["window_s"] = tracer.trace.busy_s, tracer.trace.window_s
        out["breakdown"] = {"device_ops": tracer.trace.device_ops(),
                            "idle_gaps": tracer.trace.idle_gaps()}
        out["trace_matched"] = [tracer.trace.matched, len(tracer.trace.ops)]
    out["checks"] = checks
    out["host"] = host
    return out
