"""The port's GSPMD strategies against the JAX package, on the CPU, in fp32.

``gspmd_tp`` (:func:`repro_torch.launch.steps._make_tp_train_step`, accum 1
and 2) against the reference's ``_make_tp_train_step`` jitted on a
one-device mesh; ``gspmd_pp`` (:mod:`repro_torch.core.pipeline_gspmd`)
against the reference's stacked-stage step on a (4, 2) mesh of host
devices, which needs 8 of them: this file runs itself as a script in a
subprocess under ``--xla_force_host_platform_device_count=8`` and writes the
reference's results to an ``.npz``.  Weights come from the JAX init through
``params_from_jax``; tokens (and whisper's frames) from numpy seeds.

Gates (``tests/test_torch_pipeline.py``'s): the loss (and ``ce``, ``aux``)
within 1e-5 relative; each gradient leaf within 1e-4 x max(1, max|g|),
the gradient read from the step's own first moment (``m = (1 - b1) x
clip(g)``, divided by the clip scale from its ``grad_norm``); the params
after the step within 2e-3 where the gradient decides Adam's first step
(``_param_err``); ``meta`` equal.
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

from repro.configs import RunConfig, ShapeConfig, get_config, reduced_config
from repro.launch import steps as jsteps
from repro.launch.mesh import compat_make_mesh
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
import repro_torch.configs as tc
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import pipeline_gspmd as tgpp
from repro_torch.core import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from test_torch_pipeline import GRAD_TOL, LOSS_TOL, NORM_TOL, OPT, PARAM_TOL, _param_err

ROOT = Path(__file__).resolve().parents[1]
BATCH = 8
B1 = jadamw.AdamWConfig(**OPT).b1


def _configs(arch, n_layers=None, **kw):
    cfg, tcfg = reduced_config(get_config(arch)), tc.reduced_config(tc.get_config(arch))
    if n_layers:
        cfg, tcfg = (dataclasses.replace(c, n_layers=n_layers) for c in (cfg, tcfg))
    seq = 64 if cfg.attention == "chunked_local" else 32      # past the reduced chunk
    rkw = dict(param_dtype="float32", compute_dtype="float32", remat=False, **kw)
    return (cfg, tcfg, ShapeConfig("t", seq, BATCH, "train"),
            tc.ShapeConfig("t", seq, BATCH, "train"), RunConfig(**rkw), tc.RunConfig(**rkw))


def _batch(cfg, seq):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq), dtype=np.int32)}
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal((BATCH, cfg.frontend_seq, cfg.d_model)).astype(
            np.float32)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_from_m(m_leaves, grad_norm, clip_norm=1.0):
    """The step's gradient from its first moment after one AdamW update."""
    scale = min(1.0, clip_norm / (grad_norm + 1e-9))
    return [m / ((1 - B1) * scale) for m in m_leaves]


def _check(port, ref, what):
    """port / ref: dicts of loss, ce, aux, grad_norm (floats), m, new (port
    param trees), meta."""
    for k in ("loss", "ce", "aux"):
        assert abs(port[k] - ref[k]) <= LOSS_TOL * max(abs(ref[k]), 1e-6), (what, k, port[k],
                                                                          ref[k])
    assert abs(port["grad_norm"] - ref["grad_norm"]) <= NORM_TOL * ref["grad_norm"], what
    gp = _grads_from_m(list(leaves(port["m"])), port["grad_norm"])
    gr = _grads_from_m(list(leaves(ref["m"])), ref["grad_norm"])
    assert len(gp) == len(gr)
    for i, (a, b) in enumerate(zip(gp, gr)):
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        assert err <= GRAD_TOL, (what, i, err)
    perr = _param_err(port["new"], ref["new"], ref["m"], B1)
    assert perr < PARAM_TOL, (what, perr)


# --- gspmd_tp against the reference's step on one device -----------------------

TP_CASES = [(a, accum) for a in ("granite-8b", "whisper-small", "llama4-scout-17b-a16e")
            for accum in (1, 2)]


@pytest.mark.parametrize("arch,accum", TP_CASES, ids=[f"{a}-accum{n}" for a, n in TP_CASES])
def test_tp_step_matches_the_reference(arch, accum):
    cfg, tcfg, shape, tshape, rcfg, trcfg = _configs(arch, grad_accum=accum)
    jmesh = compat_make_mesh((1, 1), ("data", "model"))
    ref = jsteps._make_tp_train_step(cfg, shape, rcfg, jmesh, jadamw.AdamWConfig(**OPT))
    params = jbuild(cfg, rcfg).init(jax.random.key(0))
    batch = _batch(cfg, shape.seq_len)
    with jmesh:
        step = jax.jit(ref["fn"], in_shardings=ref["in_shardings"],
                       out_shardings=ref["out_shardings"])
        rnew, ropt, rmet = step(params, jadamw.init(params), jax.tree.map(jnp.asarray, batch))
    built = tsteps._make_tp_train_step(tcfg, tshape, trcfg, make_host_mesh((1, 1)),
                                       adamw.AdamWConfig(**OPT), device="cpu")
    assert built["meta"] == ref["meta"] and built["meta"]["accum"] == accum
    p = params_from_jax(_np(params), device="cpu")
    new, opt, met = built["fn"](p, adamw.init(p), {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert sorted(met) == sorted(rmet)
    port = {k: met[k].item() for k in ("loss", "ce", "aux", "grad_norm")}
    refd = {k: float(rmet[k]) for k in ("loss", "ce", "aux", "grad_norm")}
    _check(dict(port, m=opt["m"], new=new),
           dict(refd, m=params_from_jax(_np(ropt["m"]), device="cpu"),
                new=params_from_jax(_np(rnew), device="cpu")), f"{arch} accum {accum}")


def test_tp_accumulation_is_the_mean_over_microbatches():
    """At accum 2 the loss is the mean of the two contiguous row blocks'
    losses and the metrics are the last block's."""
    cfg, tcfg, shape, tshape, rcfg, trcfg = _configs("granite-8b", grad_accum=2)
    built = tsteps._make_tp_train_step(tcfg, tshape, trcfg, make_host_mesh((1, 1)),
                                       adamw.AdamWConfig(**OPT), device="cpu")
    model = built["model"]
    p = model.init(0)
    toks = torch.from_numpy(_batch(cfg, shape.seq_len)["tokens"])
    with torch.no_grad():
        halves = [model.loss(p, {"tokens": toks[i * 4:(i + 1) * 4]}) for i in range(2)]
    _, _, met = built["fn"](p, adamw.init(p), {"tokens": toks})
    mean = (halves[0][0] + halves[1][0]) / 2
    assert abs(met["loss"].item() - mean.item()) <= 1e-6 * abs(mean.item())
    assert abs(met["ce"].item() - halves[1][1]["ce"].item()) <= 1e-6


# --- gspmd_pp against the reference's stacked-stage step (subprocess) ---------

PP_CASES = {"grok": ("grok-1-314b", 8), "llama4": ("llama4-scout-17b-a16e", 8),
            "granite6": ("granite-8b", 6)}
PP_MESH = (4, 2)


def _reference_run(out_path: str) -> None:
    """Script side: the reference's gspmd_pp step on a (4, 2) mesh of host
    devices for each case of ``PP_CASES``."""
    from repro.core import pipeline_gspmd as jgpp
    out = {}
    mesh = compat_make_mesh(PP_MESH, ("data", "model"))
    for name, (arch, n_layers) in PP_CASES.items():
        cfg, _, shape, _, rcfg, _ = _configs(arch, n_layers, microbatches=4)
        built = jgpp.make_gspmd_pp_train_step(cfg, shape, rcfg, mesh, jadamw.AdamWConfig(**OPT))
        params = jbuild(cfg, rcfg).init(jax.random.key(0))
        pp = built["to_pipeline"](params)
        batch = jax.tree.map(jnp.asarray, _batch(cfg, shape.seq_len))
        with mesh:
            step = jax.jit(built["fn"], in_shardings=built["in_shardings"],
                           out_shardings=built["out_shardings"])
            new_pp, new_opt, metrics = step(pp, jadamw.init(pp), batch)
        for key, tree in (("init", params), ("new", built["from_pipeline"](jax.device_get(new_pp))),
                          ("m", built["from_pipeline"](jax.device_get(new_opt["m"])))):
            for i, a in enumerate(jax.tree.leaves(tree)):
                out[f"{name}/{key}/{i}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(pp["blocks"])):
            out[f"{name}/pp_shape/{i}"] = np.asarray(a.shape)
        for k in ("loss", "ce", "aux", "grad_norm"):
            out[f"{name}/{k}"] = np.asarray(metrics[k])
        out[f"{name}/meta"] = np.asarray(repr(sorted(built["meta"].items())))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpp_ref") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}"}
    run = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return dict(np.load(path))


def _ref_tree(ref, key, structure):
    return jax.tree.unflatten(structure, [ref[f"{key}/{i}"]
                                          for i in range(structure.num_leaves)])


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_pp_step_matches_the_reference(reference_runs, name):
    arch, n_layers = PP_CASES[name]
    ref = {k.split("/", 1)[1]: v for k, v in reference_runs.items() if k.startswith(name + "/")}
    cfg, tcfg, shape, tshape, rcfg, trcfg = _configs(arch, n_layers, microbatches=4)
    structure = jax.tree.structure(jax.eval_shape(
        lambda: jbuild(cfg, rcfg).init(jax.random.key(0))))
    init, new, m = (params_from_jax(_ref_tree(ref, k, structure), device="cpu")
                    for k in ("init", "new", "m"))
    built = tgpp.make_gspmd_pp_train_step(tcfg, tshape, trcfg, make_host_mesh(PP_MESH),
                                          adamw.AdamWConfig(**OPT), device="cpu")
    assert repr(sorted(built["meta"].items())) == str(ref["meta"])
    assert built["meta"]["n_pad_layers"] == (2 if name == "granite6" else 0)
    pp = built["to_pipeline"](init)
    # the stage-slot layout stacks into the reference's (S, lps, ...) leaves
    stacked = [t.shape for t in leaves(tsh.reference_layout(pp)["blocks"])]
    assert [tuple(s) for s in stacked] == [tuple(ref[f"pp_shape/{i}"])
                                           for i in range(len(stacked))]
    back = built["from_pipeline"](pp)
    assert all(a is b for a, b in zip(leaves(back), leaves(init)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, shape.seq_len).items()}
    new_pp, opt, met = built["fn"](pp, adamw.init(pp), batch)
    port = {k: met[k].item() for k in ("loss", "ce", "aux", "grad_norm")}
    refd = {k: float(ref[k]) for k in ("loss", "ce", "aux", "grad_norm")}
    if tcfg.n_experts:
        assert port["aux"] > 0
    _check(dict(port, m=built["from_pipeline"](opt["m"]), new=built["from_pipeline"](new_pp)),
           dict(refd, m=m, new=new), name)


def test_pp_loss_equals_the_unsplit_mean():
    """The pipelined loss of M microbatches is the mean of the unsplit
    model's loss over the same contiguous row blocks (granite, 6 layers on
    4 stages: two pad slots)."""
    cfg, tcfg, shape, tshape, rcfg, trcfg = _configs("granite-8b", 6, microbatches=4)
    built = tgpp.make_gspmd_pp_train_step(tcfg, tshape, trcfg, make_host_mesh((4, 1)),
                                          device="cpu")
    model = built["model"]
    p = model.init(0)
    toks = torch.from_numpy(_batch(cfg, shape.seq_len)["tokens"])
    with torch.no_grad():
        loss, metrics = built["loss_fn"](built["to_pipeline"](p), {"tokens": toks})
        want = sum(model.loss(p, {"tokens": toks[2 * i:2 * i + 2]})[0] for i in range(4)) / 4
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    assert metrics["aux"].item() == 0.0


def test_pp_refuses_what_has_no_stage_layout():
    for arch in ("whisper-small", "zamba2-7b"):
        _, tcfg, _, tshape, _, trcfg = _configs(arch)
        with pytest.raises(ValueError, match="gspmd_pp"):
            tgpp.make_gspmd_pp_train_step(tcfg, tshape, trcfg, make_host_mesh((2, 1)),
                                          device="cpu")


if __name__ == "__main__":
    _reference_run(sys.argv[1])
