"""The stacked-stage GPipe pipeline, PP on "data" x TP on "model" (port of
``repro/core/pipeline_gspmd.py``).

The paper's pipeline (:mod:`repro_torch.core.pipeline`) puts stages on
"model"; the MoE giants also need tensor/expert parallelism within a stage.
This variant puts S = ``mesh.shape["data"]`` stages on "data" and keeps
"model" for TP inside each stage.  The reference runs it inside one jit:
each tick every stage runs its layers on its buffer slot (a ``vmap`` over
the stage-stacked weights) and the buffer shifts by one stage; it masks
what the bubble ticks give (the loss of a microbatch outside [0, M) and
the MoE aux of a dead (stage, tick) pair), and no masked value reaches a
live one.  So the schedule computes the mean of the model's loss over M
microbatches, contiguous row blocks of the global batch (the reference's
``tokens.reshape(M, B / M, T)``): ``sum(ce) / M + AUX_COEF * aux / M``.
The port emulates the mesh on one device (:mod:`repro_torch.launch.mesh`),
where the ticks would only run the stages one after another, so it
computes that mean directly: ``model.loss`` of each microbatch on the
params taken out of the stage slots, the backward by autograd through all
M (the GPipe schedule's all-forward, all-backward).  Loss, aux and
gradients are the reference's (the parity tests hold it).

Params: the stage-slot layout of :mod:`repro_torch.core.pipeline`
(``to_pipeline``: S lists of ``layers_per_stage`` slots, pad slots ``{}``,
each layer held once); the reference stacks ``(S, lps, ...)`` leaves with
zeros in the pad slots.  The spec trees are the reference's
(:mod:`repro_torch.core.sharding`, leading axes ("stage", "layers")).
The reference's stages run their layers only: zamba2's shared block and
the encoder-decoder have no place in its layout, and the builder refuses
such a config.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.convert import leaves, unflatten
from repro_torch.core import sharding as sh
from repro_torch.core.partition import plan_pipeline
from repro_torch.core.pipeline import from_pipeline, to_pipeline
from repro_torch.models import lm as LM
from repro_torch.models.api import build_model
from repro_torch.optim import adamw

AUX_COEF = LM.AUX_COEF


def make_gspmd_pp_train_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                             opt_cfg: Optional[adamw.AdamWConfig] = None,
                             device="cuda") -> dict:
    """``fn(params_pp, opt_state, batch) -> (params_pp, opt_state,
    metrics)`` on ``device`` (default ``cuda``), AdamW over the stage-slot
    tree in place; ``meta`` is the reference's (S, M, layers_per_stage,
    n_pad_layers, the multipliers); ``loss_fn(params_pp, batch) -> (loss,
    {"ce", "aux"})`` is the pipelined loss alone; ``to_pipeline`` /
    ``from_pipeline`` convert params."""
    if cfg.n_enc_layers or (cfg.family == "hybrid" and cfg.attn_every):
        raise ValueError(f"{cfg.arch_id}: gspmd_pp runs a stack of uniform blocks; the "
                         f"encoder-decoder and zamba2's shared block have no stage layout")
    from repro_torch.launch.steps import TRAIN_METRICS, _microbatch
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    model = build_model(cfg, rcfg, device=device)

    stage_axis = mesh.shape["data"]
    plan = plan_pipeline(cfg.n_layers, stage_axis, rcfg.microbatches, "gpipe",
                         candidates=(stage_axis,))
    S, lps = plan.n_stages, plan.layers_per_stage
    dp = mesh.shape.get("pod", 1)
    b_dp = shape.global_batch // dp        # per-pod batch (for picking M)
    m = rcfg.microbatches or min(b_dp, 2 * S)
    while b_dp % m:
        m -= 1
    b_mb = shape.global_batch // m         # global microbatch rows
    t_tok = shape.seq_len - (cfg.frontend_seq if cfg.frontend else 0)
    n_ticks = m + S - 1

    def loss_fn(params, batch):
        if tuple(batch["tokens"].shape) != (m * b_mb, t_tok):
            raise ValueError(f"batch {tuple(batch['tokens'].shape)} is not {m} microbatches "
                             f"of {b_mb} x {t_tok} tokens")
        flat = from_pipeline(params, plan, cfg.n_layers)
        ce = aux = 0.0
        for i in range(m):
            _, mb = model.loss(flat, _microbatch(batch, i, m))
            ce, aux = ce + mb["ce"], aux + mb["aux"]
        ce, aux = ce / m, aux / m
        return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}

    def train_step(params, opt_state, batch):
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat)
        params, opt_state, stats = adamw.update(opt_cfg, unflatten(params, grads), opt_state,
                                                params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **stats)

    # ---- specs & shardings ----
    pp_shape = to_pipeline(build_model(cfg, rcfg, device="meta").init(0), plan)
    opt_shape = adamw.init(pp_shape)
    batch_specs = model.input_specs(shape)
    p_shard = sh.param_shardings(pp_shape, mesh, "gspmd_pp")
    opt_shard = {"m": p_shard, "v": p_shard, "step": ()}
    pod = "pod" if "pod" in mesh.shape else None           # the reference's P(pod or None)
    b_shard = sh.map_with_path(lambda _, a: (pod,) if a.dim() else (), batch_specs)
    return dict(
        fn=train_step,
        loss_fn=loss_fn,
        args=(pp_shape, opt_shape, batch_specs),
        in_shardings=(p_shard, opt_shard, b_shard),
        out_shardings=(p_shard, opt_shard, {k: () for k in TRAIN_METRICS}),
        donate_argnums=(0, 1),
        meta={"strategy": "gspmd_pp", "S": S, "M": m,
              "layers_per_stage": lps, "n_pad_layers": plan.n_pad,
              "layers_multiplier": lps,
              "tick_multiplier": n_ticks},
        model=model,
        plan=plan,
        to_pipeline=functools.partial(to_pipeline, plan=plan),
        from_pipeline=functools.partial(from_pipeline, plan=plan, n_layers=cfg.n_layers),
    )
