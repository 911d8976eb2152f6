"""Serving launcher: continuous-batching engine + optional async tools
(port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --max-new 16 [--tools] [--device cuda]

Runs on ``cuda`` unless ``--device cpu`` is given.  Every arch id of the
registry serves, at its reduced config: rwkv6-1.6b and zamba2-7b on
recurrent state lanes (the engine's default backend for them), the others on
dense lanes, whisper-small's requests each with frames from
:class:`FrontendPipeline` (internvl2's, like the reference's, with tokens
alone).
``--tools`` runs the paper's §4.3 agent scenario instead: three vector-DB
searches offloaded to a worker pool while the model reasons and summarises.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, RunConfig, get_config, reduced_config
from repro_torch.data.synthetic import DataConfig, FrontendPipeline
from repro_torch.models.api import build_model
from repro_torch.offload.tools import ToolExecutor
from repro_torch.offload.vectordb import VectorDB
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.tool_loop import run_scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tools", action="store_true",
                    help="run the paper's §4.3 agent scenario instead")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    model = build_model(cfg, rcfg, device=args.device)
    params = model.init(0)
    engine = ServeEngine(model, params, args.max_batch, args.max_len)

    if args.tools:
        db = VectorDB(n_docs=20_000, dim=128)
        ex = ToolExecutor(n_workers=3)
        ex.register("vector_db_begin_search",
                    lambda query, k: db.search_text(query, int(k)),
                    simulated_seconds=0.5)
        tr = run_scenario(engine, ex,
                          ["google search engine", "apple ipod",
                           "microsoft windows"], async_tools=True)
        ex.shutdown()
        print(f"[serve] agent scenario: total {tr.total:.2f}s, "
              f"tool_wait {tr.time_in('tool_wait'):.2f}s "
              f"(tools ran fully overlapped), device {args.device}")
        for seg in tr.timeline():
            print(f"  {seg['kind']:10s} {seg['start']:6.2f}-{seg['end']:6.2f}s"
                  f" {seg['label']}")
        return

    rng = np.random.default_rng(0)
    extra = [{} for _ in range(args.requests)]
    if cfg.family == "audio":                    # the encoder's input, one clip a request
        frames = FrontendPipeline(DataConfig(cfg.vocab_size, 2, args.requests),
                                  cfg.frontend_seq, cfg.d_model, key="frames").batch(0)["frames"]
        extra = [{"frames": f} for f in frames]
    t0 = time.perf_counter()
    for i in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab_size, size=8 + i % 5),
                      max_new=args.max_new, **extra[i])
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
