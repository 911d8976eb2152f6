"""Step builders: train, prefill and decode steps with their sharding
annotations (port of ``repro/launch/steps.py``).

Each builder returns the reference's keys: ``fn``, ``args`` (``meta``
stand-ins of its inputs), ``in_shardings`` / ``out_shardings`` (spec trees,
:mod:`repro_torch.core.sharding`), ``donate_argnums``, ``meta`` and
``model``.  The reference hands them to ``jax.jit(...).lower``; here
``fn`` runs eagerly on the model's device (the card unless the caller
passes ``device="cpu"``), the spec trees say how the reference's meshes
would lay each input out, and the dry-run (:mod:`repro_torch.launch.dryrun`)
accounts them per device.  A train step updates params and moments in
place (``optim/adamw.py``) and returns the same trees; "donated" inputs
are exactly those.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.convert import leaves, unflatten
from repro_torch.core import sharding as sh
from repro_torch.core import strategy as strat
from repro_torch.launch.mesh import dp_degree
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw

# what a train step's metrics hold: the model's, the mean loss, AdamW's
TRAIN_METRICS = ("ce", "aux", "loss", "grad_norm", "lr")


def _params_shape(cfg: ModelConfig, rcfg: RunConfig) -> dict:
    """The params' shapes and dtypes as ``meta`` tensors (no draw)."""
    return build_model(cfg, rcfg, device="meta").init(0)


def _logits_sharding(mesh, batch: int) -> sh.Spec:
    return (sh.data_entry(mesh),) if batch % dp_degree(mesh) == 0 else ()


def pick_grad_accum(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Bound per-microbatch tokens/device to ~8k (activation memory)."""
    dp = dp_degree(mesh)
    local_seqs = max(1, shape.global_batch // dp)
    tokens_dev = local_seqs * shape.seq_len
    target = max(1, tokens_dev // 8192)
    accum = 1
    for k in range(1, local_seqs + 1):
        if local_seqs % k == 0 and k <= target:
            accum = k
    return accum


# ---------------------------------------------------------------------------
# gspmd_tp / gspmd_pp train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                    opt_cfg: adamw.AdamWConfig = None, strategy: str = None,
                    device="cuda") -> dict:
    strategy = strategy or strat.resolve(cfg, shape, rcfg)
    if strategy == "pp_shardmap":
        from repro_torch.core import pipeline as pp
        return pp.make_pp_train_step(cfg, shape, rcfg, mesh, opt_cfg, device=device)
    if strategy == "gspmd_pp":
        from repro_torch.core import pipeline_gspmd as gpp
        return gpp.make_gspmd_pp_train_step(cfg, shape, rcfg, mesh, opt_cfg, device=device)
    return _make_tp_train_step(cfg, shape, rcfg, mesh, opt_cfg, device=device)


def _microbatch(batch: Dict[str, torch.Tensor], i: int, accum: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``accum``: contiguous row blocks of each input
    (the reference's ``reshape((accum, B // accum) + ...)``)."""
    def cut(a):
        if not a.dim():
            return a
        r = a.shape[0] // accum
        return a[i * r:(i + 1) * r]
    return {k: cut(v) for k, v in batch.items()}


def _make_tp_train_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                        opt_cfg=None, device="cuda") -> dict:
    """Data x tensor parallel training: one step is ``accum`` sequential
    microbatches, their gradients summed in fp32 and divided by ``accum``,
    the loss their mean and the model's metrics the last microbatch's; then
    one AdamW update."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    model = build_model(cfg, rcfg, device=device)
    fsdp = rcfg.fsdp or strat.wants_fsdp(cfg, shape)
    accum = rcfg.grad_accum if rcfg.grad_accum > 1 else pick_grad_accum(cfg, shape, mesh)
    if rcfg.seq_shard:
        raise ValueError("seq_shard: the port's model reads no activation hint and the "
                         "dry-run accounts no sequence-sharded residual")

    def train_step(params, opt_state, batch):
        flat = list(leaves(params))
        for p in flat:                       # restored leaves come back without grad
            p.requires_grad_(True)
        if accum == 1:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, flat)
            loss = loss.detach()
        else:
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for i in range(accum):
                lmb, metrics = model.loss(params, _microbatch(batch, i, accum))
                for a, g in zip(gacc, torch.autograd.grad(lmb, flat)):
                    a.add_(g.to(torch.float32))
                loss = loss + lmb.detach()
            grads = [a / accum for a in gacc]
            loss = loss / accum
        params, opt_state, stats = adamw.update(opt_cfg, unflatten(params, grads), opt_state,
                                                params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss, **stats)

    # --- specs & shardings ---------------------------------------------------
    params_shape = _params_shape(cfg, rcfg)
    opt_shape = adamw.init(params_shape)
    batch_specs = model.input_specs(shape)
    p_shard = sh.param_shardings(params_shape, mesh, "gspmd_tp", fsdp=fsdp)
    # ZeRO-1: moments take fsdp-style sharding regardless (sharded over data)
    m_shard = sh.param_shardings(params_shape, mesh, "gspmd_tp", fsdp=rcfg.zero1 or fsdp)
    opt_shard = {"m": m_shard, "v": m_shard, "step": ()}
    b_shard = sh.batch_shardings(batch_specs, mesh)
    return dict(
        fn=train_step,
        args=(params_shape, opt_shape, batch_specs),
        in_shardings=(p_shard, opt_shard, b_shard),
        out_shardings=(p_shard, opt_shard, {k: () for k in TRAIN_METRICS}),
        donate_argnums=(0, 1),
        meta={"strategy": "gspmd_tp", "fsdp": fsdp, "accum": accum,
              "seq_shard": rcfg.seq_shard,
              "layers_multiplier": 1 if rcfg.unroll_layers else cfg.n_layers,
              "accum_multiplier": accum},
        model=model,
    )


# ---------------------------------------------------------------------------
# serve steps (prefill + decode): gspmd_tp for every family
# ---------------------------------------------------------------------------

def _serve_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Serving params: shard over "data" too when a model-axis-only shard
    would exceed ~4 GB/device (grok/llama4/yi/command-r)."""
    return cfg.total_params() * 2 / mesh.shape["model"] > 4e9


def prefill_cache_specs(model: Model, shape: ShapeConfig) -> dict:
    """The decode cache a prefill of this cell returns (``seq_len``
    positions), as ``meta`` tensors: the decode cell's input cache."""
    return model.input_specs(dataclasses.replace(shape, kind="decode"))["cache"]


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                      device="cuda") -> dict:
    model = build_model(cfg, rcfg, device=device)

    def prefill(params, batch):
        return model.prefill(params, batch, shape.seq_len)

    params_shape = _params_shape(cfg, rcfg)
    batch_specs = model.input_specs(shape)
    p_shard = sh.param_shardings(params_shape, mesh, "gspmd_tp", fsdp=_serve_fsdp(cfg, mesh))
    cache_shard = sh.cache_shardings(prefill_cache_specs(model, shape), mesh, cfg)
    return dict(
        fn=prefill,
        args=(params_shape, batch_specs),
        in_shardings=(p_shard, sh.batch_shardings(batch_specs, mesh)),
        out_shardings=(_logits_sharding(mesh, shape.global_batch), cache_shard),
        donate_argnums=(),
        meta={"strategy": "gspmd_tp",
              "layers_multiplier": 1 if rcfg.unroll_layers else cfg.n_layers},
        model=model,
    )


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                     device="cuda") -> dict:
    model = build_model(cfg, rcfg, device=device)

    def decode(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    params_shape = _params_shape(cfg, rcfg)
    specs = model.input_specs(shape)
    cache_specs, token_specs = specs["cache"], specs["tokens"]
    p_shard = sh.param_shardings(params_shape, mesh, "gspmd_tp", fsdp=_serve_fsdp(cfg, mesh))
    c_shard = sh.cache_shardings(cache_specs, mesh, cfg)
    t_shard = sh.batch_shardings(token_specs, mesh)
    return dict(
        fn=decode,
        args=(params_shape, cache_specs, token_specs),
        in_shardings=(p_shard, c_shard, t_shard),
        out_shardings=(_logits_sharding(mesh, shape.global_batch), c_shard),
        donate_argnums=(1,),
        meta={"strategy": "gspmd_tp",
              "layers_multiplier": 1 if rcfg.unroll_layers else cfg.n_layers},
        model=model,
    )


def make_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
              strategy: str = None, device="cuda") -> dict:
    """Dispatch on the shape kind: train_step / prefill / decode."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, rcfg, mesh, strategy=strategy, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, rcfg, mesh, device=device)
    return make_decode_step(cfg, shape, rcfg, mesh, device=device)
