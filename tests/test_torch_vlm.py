"""internvl2-1b (family ``vlm``: ``qkv_bias``, stubbed vision rows ahead of
the tokens) in the port against the JAX package, on the CPU in fp32.

Reduced config (16 frontend rows of width 128), weights from the JAX init
through ``params_from_jax``, rows from ``FrontendPipeline``: prefill and
decode logits within 1e-5 (the cache's positions count the rows); greedy
tokens equal to the JAX engine's (rows as a request's extra input, each
prefilled alone); the loss and every gradient within 1e-4 x max(1,
max|g|); the pipelined step with frontend batches against the JAX unsplit
step and against the reference's own pipelined step (run in a subprocess
on 2 host devices, as ``tests/test_torch_pipeline.py`` does).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import pipeline as tpp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.serving.engine import ServeEngine
from test_torch_families import (GRAD_TOL, LOSS_TOL, check_loss_and_grads,
                                 check_prefill_decode, extras, models, np_tree, rel, serve,
                                 tokens)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internvl2-1b"
N_LAYERS = 4
SEQ, BATCH, T_TOK = 48, 4, 32          # 16 frontend rows + 32 tokens a sequence
OPT = dict(lr=1e-2, warmup_steps=0, schedule="const", weight_decay=0.0)


@pytest.fixture(scope="module")
def pair():
    return models(ARCH, seed=0)


def test_prefill_with_rows_and_decode_match_jax(pair):
    model, params, tmodel, tparams = pair
    assert model.cfg.qkv_bias and "bq" in tparams["blocks"][0]["attn"]
    batch = {"tokens": tokens(0, (2, 12)), **extras(model.cfg, 2, seed=1)}
    assert batch["frontend"].shape == (2, 16, 128)
    ct, _ = check_prefill_decode(model, params, tmodel, tparams, batch, steps=5)
    assert ct["pos"].tolist() == [16 + 12 + 5] * 2
    check_prefill_decode(model, params, tmodel, tparams, {"tokens": tokens(2, (2, 9))})


def test_engine_tokens_match_jax(pair):
    model, params, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=2 + 3 * i) for i in range(4)]
    rows = extras(model.cfg, 4, seed=4)["frontend"]
    inputs = [{"frontend": r} for r in rows]
    port, eng = serve(ServeEngine, tmodel, tparams, prompts, inputs, max_new=5)
    ref, _ = serve(JaxEngine, model, params, prompts, inputs, max_new=5)
    assert port == ref and len(port) == 4
    assert eng.metrics_snapshot().prefill_dispatches == 4
    alone, _ = serve(ServeEngine, tmodel, tparams, [prompts[3]], [inputs[3]], max_new=5,
                     max_batch=1)
    assert alone[0] == port[3]


def test_loss_with_rows_and_grads_match_jax(pair):
    model, params, tmodel, tparams = pair
    batch = {"tokens": tokens(5, (2, 20)), **extras(model.cfg, 2, seed=5)}
    check_loss_and_grads(model, params, tmodel, tparams, batch)


# --- the pipelined step with frontend batches ----------------------------------

def _pp_configs():
    from repro.configs import RunConfig, get_config, reduced_config
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), n_layers=N_LAYERS)
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=False, schedule="hybrid",
              microbatches=2)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(ARCH)),
                               n_layers=N_LAYERS)
    return cfg, RunConfig(**kw), tcfg, tconfigs.RunConfig(**kw)


def _pp_batch(cfg):
    toks = tokens(6, (BATCH, T_TOK), cfg.vocab_size)
    rows = extras(cfg, BATCH, seed=6)["frontend"]
    return {"tokens": toks, "frontend": rows}


def _port_pp_step(params_np):
    _, _, tcfg, trcfg = _pp_configs()
    built = tpp.make_pp_train_step(tcfg, tconfigs.ShapeConfig("t", SEQ, BATCH, "train"), trcfg,
                                   make_host_mesh((1, 2)), adamw.AdamWConfig(**OPT),
                                   device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _pp_batch(tcfg).items()}
    pp = built["to_pipeline"](params_from_jax(params_np, device="cpu"))
    loss, grads = built["schedule"](pp, batch)
    pp, _, metrics = built["fn"](pp, adamw.init(pp), batch)
    return built, loss, grads, metrics, built["from_pipeline"](pp)


def test_pipelined_step_with_rows_matches_the_unsplit_jax_step():
    from repro.models.api import build_model
    cfg, rcfg, _, _ = _pp_configs()
    model = build_model(cfg, rcfg)
    params = model.init(jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _pp_batch(cfg).items()}
    loss, grads = jax.value_and_grad(lambda p: model.loss(p, batch)[0])(params)
    built, tloss, tgrads, _, _ = _port_pp_step(np_tree(params))
    g = built["geometry"]
    assert (g.S, g.R, g.p_front, g.t_tok) == (2, 1, 16, T_TOK)
    assert abs(tloss.item() - float(loss)) <= LOSS_TOL * abs(float(loss))
    jg = list(leaves(params_from_jax(np_tree(grads), device="cpu")))
    assert len(jg) == len(list(leaves(tgrads)))
    for i, (a, b) in enumerate(zip(leaves(tgrads), jg)):
        assert rel(a, b.numpy()) <= GRAD_TOL, i


def _reference_run(out_path: str) -> None:
    """Script side: the reference's pipelined hybrid step with frontend
    batches on a (1, 2) mesh of host devices."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs import ShapeConfig
    from repro.core import pipeline as jpp
    from repro.launch.mesh import compat_make_mesh
    from repro.models.api import build_model

    cfg, rcfg, _, _ = _pp_configs()
    mesh = compat_make_mesh((1, 2), ("data", "model"))
    built = jpp.make_pp_train_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), rcfg, mesh,
                                   jadamw.AdamWConfig(**OPT))
    params = build_model(cfg, rcfg).init(jax.random.key(0))
    pp = built["to_pipeline"](params)
    with mesh:
        step = jax.jit(built["fn"], in_shardings=built["in_shardings"],
                       out_shardings=built["out_shardings"])
        new_pp, _, metrics = step(pp, jadamw.init(pp),
                                  {k: jnp.asarray(v) for k, v in _pp_batch(cfg).items()})
    out = {f"init/{i}": np.asarray(a) for i, a in enumerate(jax.tree.leaves(params))}
    new_p = built["from_pipeline"](jax.device_get(new_pp))
    out.update({f"new/{i}": np.asarray(a) for i, a in enumerate(jax.tree.leaves(new_p))})
    out["loss"] = np.asarray(metrics["loss"])
    out["grad_norm"] = np.asarray(metrics["grad_norm"])
    np.savez(out_path, **out)


def test_pipelined_step_with_rows_matches_the_references(tmp_path):
    """Loss, ``grad_norm`` (R = 1: each stage counted once in both) and the
    params after one AdamW step equal the reference's pipelined step."""
    path = tmp_path / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    ref = dict(np.load(path))
    cfg, rcfg, _, _ = _pp_configs()
    from repro.models.api import build_model
    structure = jax.tree.structure(jax.eval_shape(
        lambda: build_model(cfg, rcfg).init(jax.random.key(0))))
    init, new = (jax.tree.unflatten(structure, [ref[f"{k}/{i}"]
                                                for i in range(structure.num_leaves)])
                 for k in ("init", "new"))
    _, _, _, metrics, new_p = _port_pp_step(init)
    rloss = float(ref["loss"])
    assert abs(metrics["loss"].item() - rloss) <= LOSS_TOL * abs(rloss)
    rnorm = float(ref["grad_norm"])
    assert abs(metrics["grad_norm"].item() - rnorm) <= 1e-5 * rnorm
    # Adam's first step moves each param by ~lr x sign(g): pp_check's 2e-3
    for a, b in zip(leaves(new_p), leaves(params_from_jax(new, device="cpu"))):
        assert (a - b).abs().max().item() < 2e-3


if __name__ == "__main__":
    _reference_run(sys.argv[1])
