"""Serving launcher: continuous-batching engine (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --max-new 16 [--device cuda]

Runs on ``cuda`` unless ``--device cpu`` is given.  Every ported family
serves: ``--arch rwkv6-1.6b`` and ``--arch zamba2-7b`` on recurrent state
lanes (the engine's default backend for them), granite-8b on dense lanes.
The reference's ``--tools`` agent scenario arrives with the agentic-loop
slice (ROADMAP §1 item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, RunConfig, get_config, reduced_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    model = build_model(cfg, rcfg, device=args.device)
    params = model.init(0)
    engine = ServeEngine(model, params, args.max_batch, args.max_len)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab_size, size=8 + i % 5),
                      max_new=args.max_new)
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {engine.steps} engine steps, "
          f"{args.max_batch} {engine.backend.name} lanes, device {args.device})")
    for r in done[:3]:
        ttft = (r.first_token_t - r.submitted_t) * 1e3
        print(f"  req{r.rid}: ttft={ttft:.0f}ms tokens={r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
