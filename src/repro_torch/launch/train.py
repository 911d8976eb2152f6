"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --steps 200 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  Every arch id of the
registry trains: internvl2 on batches with frontend rows and whisper on
batches with frames (:class:`FrontendPipeline`), the rest on the token
stream.  The reference's flags
and defaults are kept, with one quirk: ``--reduced`` is ``store_true`` with
``default=True``, so the launcher always trains the reduced config (as the
reference's does; ROADMAP §3).  ``--use-kernels`` is accepted and has no
effect: the device decides between kernels and plain versions.
``--strategy pp_shardmap`` trains through the pipeline
(:mod:`repro_torch.core.pipeline`, ``--schedule gpipe|hybrid``),
``--strategy gspmd_tp`` / ``gspmd_pp`` through the step builders
(:func:`repro_torch.launch.steps.make_train_step`: data x tensor parallel
with gradient accumulation, or the stacked-stage pipeline with its stages
on "data"), each on an emulated (1, ``--model-axis``) mesh, every position
on the one device (the reference's mesh is its process's devices).  On
that mesh ``gspmd_pp`` runs one stage, as the reference's launcher does on
its one-device host mesh.  Checkpoints go every ``--ckpt-every``
steps to ``--ckpt-dir`` (under the working directory by default), and a
run resumes from the latest one.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ARCH_IDS, RunConfig, ShapeConfig, get_config, reduced_config
from repro_torch.convert import leaves, unflatten
from repro_torch.data.synthetic import DataConfig, FrontendPipeline, TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw
from repro_torch.runtime.spans import span
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def make_step_fn(model: Model, opt_cfg: adamw.AdamWConfig) -> Callable:
    """step_fn(params, opt, batch) -> (params, opt, metrics): the loss and
    its gradient by autograd, then one AdamW update (in place).  Each part
    is a span (:mod:`repro_torch.runtime.spans`): ``train.forward``,
    ``train.backward`` (remat's recomputation and the kernels' backward
    spans inside it) and ``train.adamw``."""

    def step_fn(params, opt, batch):
        flat = list(leaves(params))
        for p in flat:                       # restored leaves come back without grad
            p.requires_grad_(True)
        with span("train.forward"):
            loss, _ = model.loss(params, batch)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, flat)
        with span("train.adamw"):
            params, opt, stats = adamw.update(opt_cfg, unflatten(params, grads), opt, params)
        return params, opt, dict(loss=loss.detach(), **stats)

    return step_fn


def token_batches(pipe: TokenPipeline, start: int, device):
    """Batches of ``pipe`` from step ``start`` on, as tensors on ``device``
    (int32 tokens; float32 frontend rows or frames)."""
    step = start
    while True:
        yield {k: torch.as_tensor(v).to(device) for k, v in pipe.batch(step).items()}
        step += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers on the reduced config")
    ap.add_argument("--schedule", choices=["gpipe", "hybrid"], default="hybrid")
    ap.add_argument("--strategy", default="single",
                    choices=["single", "pp_shardmap", "gspmd_tp", "gspmd_pp"])
    ap.add_argument("--ckpt-dir", default="build/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--model-axis", type=int, default=2,
                    help="positions of the emulated mesh's model axis "
                         "(default 2, the paper's host + phone)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32",
                     remat=False, schedule=args.schedule,
                     use_kernels=args.use_kernels)
    model = build_model(cfg, rcfg, device=args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps, weight_decay=0.01)

    step_fn, to_pipeline = make_step_fn(model, opt_cfg), lambda p: p
    if args.strategy != "single":
        built = make_train_step(cfg, ShapeConfig("cli", args.seq, args.batch, "train"), rcfg,
                                make_host_mesh((1, args.model_axis)), opt_cfg,
                                strategy=args.strategy, device=args.device)
        step_fn, to_pipeline = built["fn"], built.get("to_pipeline", to_pipeline)
        print(f"[train] {args.strategy} {built['meta']}")

    def init_state():
        p = to_pipeline(model.init(0))
        print(f"[train] {cfg.arch_id}: {sum(t.numel() for t in leaves(p)) / 1e6:.2f}M params, "
              f"strategy={args.strategy}, device={model.device}")
        return p, adamw.init(p)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                      seed=rcfg.seed)
    if cfg.frontend and cfg.family != "audio":
        pipe = FrontendPipeline(dcfg, cfg.frontend_seq, cfg.d_model)
    elif cfg.family == "audio":
        pipe = FrontendPipeline(dcfg, cfg.frontend_seq, cfg.d_model, key="frames")
    else:
        pipe = TokenPipeline(dcfg)
    tr = Trainer(TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10),
                 step_fn, init_state,
                 lambda start: token_batches(pipe, start, model.device))
    out = tr.run()
    losses = out["losses"]
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {len(losses)} steps")
    return out


if __name__ == "__main__":
    main()
