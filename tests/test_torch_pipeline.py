"""The port's pipeline-parallel trainer against the JAX package, on the CPU,
in fp32 (``tests/pp_check.py``'s claims, held on the port).

Weights come from the JAX init through ``params_from_jax``.  Against the
JAX unsplit step (``value_and_grad`` + ``adamw.update``): the loss within
1e-5 relative, each gradient leaf within 1e-4 x max(1, max|g|), the params
after one AdamW step within pp_check's 2e-3 wherever the step is decided by
the gradient rather than by Adam's eps (:func:`_param_err`), ``grad_norm``
within 1e-5 relative.  Against the reference's own pipelined step, which needs several
host devices: this file runs itself as a script in a subprocess under
``--xla_force_host_platform_device_count=8`` and writes the reference's
results to an ``.npz``.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, ShapeConfig, get_config, reduced_config
from repro.core import pipeline as jpp
from repro.models.api import build_model
from repro.optim import adamw as jadamw
import repro_torch.configs as tconfigs
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import pipeline as tpp
from repro_torch.core import schedules as tsched
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-3          # pp_check's: Adam's first step is ~lr x sign(g)
# Adam's first step moves a param by lr x x / (|x| + eps), x the clipped
# gradient: where |x| >= X_MIN = 100 eps it lies within lr / 101 of
# lr x sign(x), so two steps whose gradients agree in sign lie within
# 2 lr / 101 = 2e-4 of each other whatever the summation order or clip
# scale; below it eps decides the step, and fp32's rounding of a gradient
# near 1e-8 moves the param by up to lr
X_MIN = 1e-6
COVER = 0.9               # the share of elements the param check must reach
NORM_TOL = 1e-5
SEQ, BATCH = 32, 8
OPT = dict(lr=1e-2, warmup_steps=0, schedule="const", weight_decay=0.0)   # pp_check's


def _configs(arch, n_layers, schedule):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                               n_layers=n_layers)
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=False, schedule=schedule,
              microbatches=4)
    return cfg, tcfg, RunConfig(**kw), tconfigs.RunConfig(**kw)


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (BATCH, SEQ), dtype=np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_step(tcfg, trcfg, mesh_shape, params_np, toks):
    """The port's pipelined (loss, grads) and one train step from the same
    params: (built, loss, grads, metrics, params after the step)."""
    built = tpp.make_pp_train_step(tcfg, tconfigs.ShapeConfig("t", SEQ, BATCH, "train"), trcfg,
                                   make_host_mesh(mesh_shape), adamw.AdamWConfig(**OPT),
                                   device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    pp = built["to_pipeline"](params_from_jax(params_np, device="cpu"))
    loss, grads = built["schedule"](pp, batch)
    log = list(built["schedule"].trace.log)
    pp, _, metrics = built["fn"](pp, adamw.init(pp), batch)
    return built, loss, grads, log, metrics, built["from_pipeline"](pp)


def _param_err(new_p, ref_new_p, ref_m, b1: float) -> float:
    """The worst |param difference| after Adam's first step over the
    elements whose reference clipped gradient x = m / (1 - b1) has
    |x| >= X_MIN; asserts those are at least COVER of all elements."""
    err, n_in, n_all = 0.0, 0, 0
    for a, b, m in zip(leaves(new_p), leaves(ref_new_p), leaves(ref_m)):
        keep = (m / (1 - b1)).abs() >= X_MIN
        n_in, n_all = n_in + int(keep.sum()), n_all + keep.numel()
        if keep.any():
            err = max(err, (a - b)[keep].abs().max().item())
    assert n_in >= COVER * n_all, (n_in, n_all)
    return err


def _max_rel(a: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a.detach().numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _expected_log(table, S, M, ncols):
    """The work items a table prescribes: the hybrid's "F"+"B" tick of a
    middle stage is two items; a backward's microbatch is the table's
    (GPipe) or, where the table gives only the forward's, the one whose
    cotangent arrives then (``hybrid_table``: mb b reaches stage s at tick
    b + 2S - 2 - s)."""
    out = []
    for t, tk in enumerate(table):
        for s, (op, mb) in enumerate(zip(tk.stage_ops, tk.mb)):
            if op == tsched.IDLE:
                continue
            if op == tsched.FUSED and s == S - 1:
                out.append((t, s, op, mb))
                continue
            if tsched.FWD in op:
                out.append((t, s, tsched.FWD, mb))
            if tsched.BWD in op:
                out.append((t, s, tsched.BWD, mb if op == tsched.BWD and mb is not None
                            else t - (2 * S - 2 - s)))
    return out * ncols


# pp_check's cases, on the unsplit JAX step: (arch, n_layers, schedule)
UNSPLIT = [("granite-8b", 8, "gpipe"), ("granite-8b", 8, "hybrid"), ("rwkv6-1.6b", 8, "hybrid"),
           ("rwkv6-1.6b", 8, "gpipe"), ("zamba2-7b", 12, "hybrid")]


@pytest.mark.parametrize("arch,n_layers,schedule", UNSPLIT,
                         ids=[f"{a}-{n}-{s}" for a, n, s in UNSPLIT])
def test_pipelined_step_matches_unsplit_jax_step(arch, n_layers, schedule):
    cfg, tcfg, rcfg, trcfg = _configs(arch, n_layers, schedule)
    model = build_model(cfg, rcfg)
    params = model.init(jax.random.key(0))
    toks = _tokens(cfg.vocab_size)
    opt_cfg = jadamw.AdamWConfig(**OPT)

    @jax.jit
    def ref(p):
        loss, g = jax.value_and_grad(lambda p: model.loss(p, {"tokens": jnp.asarray(toks)})[0])(p)
        new_p, new_opt, stats = jadamw.update(opt_cfg, g, jadamw.init(p), p)
        return loss, g, new_p, new_opt["m"], stats["grad_norm"]

    rloss, rgrads, rparams, rm, rnorm = ref(params)
    built, loss, grads, log, metrics, new_p = _port_step(tcfg, trcfg, (2, 4), _np(params), toks)
    g = built["geometry"]
    assert (g.S, g.R) == ((4, 1))                    # dp 2 x 4 stages
    assert abs(loss.item() - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    assert abs(metrics["loss"].item() - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    jg = list(leaves(params_from_jax(_np(rgrads), device="cpu")))
    assert len(jg) == len(list(leaves(grads)))
    for i, (a, b) in enumerate(zip(leaves(grads), jg)):
        assert _max_rel(a, b.numpy()) <= GRAD_TOL, i
    assert abs(metrics["grad_norm"].item() - float(rnorm)) <= NORM_TOL * float(rnorm)
    perr = _param_err(new_p, params_from_jax(_np(rparams), device="cpu"),
                      params_from_jax(_np(rm), device="cpu"), opt_cfg.b1)
    assert perr < PARAM_TOL, perr
    table = (tsched.hybrid_table if schedule == "hybrid" else tsched.gpipe_table)(g.S, g.M)
    assert log == _expected_log(table, g.S, g.M, ncols=2)


def test_executed_order_is_the_tables_dataflow():
    """Each stage runs its backwards in microbatch order, each after the
    stage to its right (or the fused tick) handed the cotangent over one
    tick before, and each forward one tick after the stage to its left."""
    for schedule in ("gpipe", "hybrid"):
        cfg, tcfg, rcfg, trcfg = _configs("granite-8b", 8, schedule)
        built = tpp.make_pp_train_step(tcfg, tconfigs.ShapeConfig("t", SEQ, BATCH, "train"),
                                       trcfg, make_host_mesh((1, 4)), device="cpu")
        g = built["geometry"]
        assert (g.S, g.R, g.M) == (4, 1, 4)               # one column
        params = built["model"].init(0)
        built["schedule"](built["to_pipeline"](params),
                          {"tokens": torch.from_numpy(_tokens(cfg.vocab_size))})
        log = built["schedule"].trace.log
        when = {(s, op, mb): t for t, s, op, mb in log}
        assert len(when) == len(log)
        last = g.S - 1
        for mb in range(g.M):
            for s in range(1, g.S):
                f = tsched.FUSED if (schedule == "hybrid" and s == last) else tsched.FWD
                assert when[(s, f, mb)] == when[(s - 1, tsched.FWD, mb)] + 1
            for s in range(last):
                right = (when[(last, tsched.FUSED, mb)] if schedule == "hybrid" and s == last - 1
                         else when[(s + 1, tsched.BWD, mb)])
                assert when[(s, tsched.BWD, mb)] == right + 1
        for s in range(g.S if schedule == "gpipe" else last):
            assert [mb for _, st, op, mb in log if st == s and op == tsched.BWD] == list(range(g.M))


GRID = [(n, shape, m, sch) for n in (4, 6, 8, 12, 24, 81) for shape in ((1, 2), (2, 4), (1, 16))
        for m in (0, 2, 4) for sch in ("gpipe", "hybrid")]


def test_geometry_equals_the_reference():
    """The reference's ``geometry`` reads only ``mesh.shape``: a namespace
    stands in for its mesh."""
    for n, shape, m, sch in GRID:
        cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=n)
        tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                                   n_layers=n)
        kw = dict(microbatches=m, schedule=sch)
        sh = dict(zip(("data", "model"), shape))
        rplan, rg = jpp.geometry(cfg, ShapeConfig("t", 64, 32, "train"), RunConfig(**kw),
                                 types.SimpleNamespace(shape=sh))
        plan, g = tpp.geometry(tcfg, tconfigs.ShapeConfig("t", 64, 32, "train"),
                               tconfigs.RunConfig(**kw), make_host_mesh(shape))
        assert dataclasses.asdict(plan) == dataclasses.asdict(rplan)
        assert dataclasses.asdict(g) == dataclasses.asdict(rg)
        assert plan.ticks() == rplan.ticks()


def test_moe_and_frontend_are_refused():
    cfg, tcfg, rcfg, trcfg = _configs("granite-8b", 4, "hybrid")
    shape = tconfigs.ShapeConfig("t", SEQ, BATCH, "train")
    with pytest.raises(ValueError, match="MoE"):
        tpp.geometry(dataclasses.replace(tcfg, n_experts=8), shape, trcfg, make_host_mesh())
    built = tpp.make_pp_train_step(tcfg, shape, trcfg, make_host_mesh(), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    with pytest.raises(ValueError, match="frontend"):   # rows the config has no room for
        built["schedule"](built["to_pipeline"](built["model"].init(0)),
                          {"tokens": toks, "frontend": torch.zeros(BATCH, 4, tcfg.d_model)})


def test_batches_that_do_not_split_are_refused():
    """A global batch that the data x replica columns do not divide, and a
    batch of other than the planned rows, raise rather than drop rows."""
    cfg, tcfg, rcfg, trcfg = _configs("granite-8b", 6, "hybrid")
    mesh = make_host_mesh((2, 4))
    assert tpp.geometry(tcfg, tconfigs.ShapeConfig("t", SEQ, BATCH, "train"), trcfg,
                        mesh)[1].R == 2
    with pytest.raises(ValueError, match="does not split"):
        tpp.geometry(tcfg, tconfigs.ShapeConfig("t", SEQ, 6, "train"), trcfg, mesh)
    built = tpp.make_pp_train_step(tcfg, tconfigs.ShapeConfig("t", SEQ, BATCH, "train"), trcfg,
                                   mesh, device="cpu")
    pp = built["to_pipeline"](built["model"].init(0))
    toks = np.concatenate([_tokens(cfg.vocab_size)] * 2)
    for rows in (BATCH - 4, BATCH + 4):
        with pytest.raises(ValueError, match="is not 2 x 2 columns"):
            built["schedule"](pp, {"tokens": torch.from_numpy(toks[:rows])})


# --- against the reference's own pipelined step (subprocess) ------------------

REF_CASES = {"r1": 8, "r2": 6}          # granite hybrid on a (2, 4) mesh: R = 1 and R = 2


def _reference_run(out_path: str) -> None:
    """Script side: the reference's pipelined granite hybrid step on a
    (2, 4) mesh of host devices, for each case of ``REF_CASES``."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs import RunConfig, ShapeConfig, get_config, reduced_config
    from repro.core import pipeline as jpp
    from repro.launch.mesh import compat_make_mesh
    from repro.models.api import build_model
    from repro.optim import adamw as jadamw

    mesh = compat_make_mesh((2, 4), ("data", "model"))
    out = {}
    for name, n_layers in REF_CASES.items():
        cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=n_layers)
        rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                         schedule="hybrid", microbatches=4)
        built = jpp.make_pp_train_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), rcfg, mesh,
                                       jadamw.AdamWConfig(**OPT))
        params = build_model(cfg, rcfg).init(jax.random.key(0))
        toks = _tokens(cfg.vocab_size)
        pp = built["to_pipeline"](params)
        with mesh:
            step = jax.jit(built["fn"], in_shardings=built["in_shardings"],
                           out_shardings=built["out_shardings"])
            new_pp, new_opt, metrics = step(pp, jadamw.init(pp), {"tokens": jnp.asarray(toks)})
        new_p = built["from_pipeline"](jax.device_get(new_pp))
        new_m = built["from_pipeline"](jax.device_get(new_opt["m"]))
        for i, a in enumerate(jax.tree.leaves(params)):
            out[f"{name}/init/{i}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(new_p)):
            out[f"{name}/new/{i}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(new_m)):
            out[f"{name}/m/{i}"] = np.asarray(a)
        out[f"{name}/loss"] = np.asarray(metrics["loss"])
        out[f"{name}/grad_norm"] = np.asarray(metrics["grad_norm"])
        out[f"{name}/meta"] = np.asarray(repr(sorted(built["meta"].items())))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp_ref") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", sorted(REF_CASES))
def test_matches_the_reference_pipelined_step(reference_runs, name):
    """Loss, meta and params after the step equal the reference's
    pipelined step.  Its ``grad_norm`` counts each stage R times (it takes
    the norm over its replicated layout): at R = 1 it equals the port's,
    at R = 2 it equals sqrt(2 |g_blocks|^2 + |g_rest|^2) of the port's
    gradients, which count each stage once."""
    ref = {k.split("/", 1)[1]: v for k, v in reference_runs.items() if k.startswith(name + "/")}
    cfg, tcfg, rcfg, trcfg = _configs("granite-8b", REF_CASES[name], "hybrid")
    structure = jax.tree.structure(jax.eval_shape(
        lambda: build_model(cfg, rcfg).init(jax.random.key(0))))
    init = jax.tree.unflatten(structure, [ref[f"init/{i}"] for i in range(structure.num_leaves)])
    new, m = (jax.tree.unflatten(structure, [ref[f"{k}/{i}"] for i in range(structure.num_leaves)])
              for k in ("new", "m"))
    built, loss, grads, _, metrics, new_p = _port_step(tcfg, trcfg, (2, 4), init,
                                                       _tokens(cfg.vocab_size))
    assert repr(sorted(built["meta"].items())) == str(ref["meta"])
    rloss = float(ref["loss"])
    assert abs(metrics["loss"].item() - rloss) <= LOSS_TOL * abs(rloss)
    perr = _param_err(new_p, params_from_jax(new, device="cpu"),
                      params_from_jax(m, device="cpu"), jadamw.AdamWConfig(**OPT).b1)
    assert perr < PARAM_TOL, perr
    sq = lambda tree: sum(float(torch.sum(torch.square(t))) for t in leaves(tree))
    g_blocks = sq(grads["blocks"])
    g_rest = sq({k: v for k, v in grads.items() if k != "blocks"})
    R = built["geometry"].R
    assert R == {"r1": 1, "r2": 2}[name]
    ref_norm = float(ref["grad_norm"])
    assert abs(np.sqrt(R * g_blocks + g_rest) - ref_norm) <= NORM_TOL * ref_norm
    port_norm = metrics["grad_norm"].item()
    assert abs(port_norm - np.sqrt(g_blocks + g_rest)) <= NORM_TOL * port_norm
    if R == 2:
        assert ref_norm > port_norm * 1.01


# --- the launcher, and the port without JAX -----------------------------------

def test_launcher_trains_through_the_pipeline(tmp_path, capsys):
    out = tlaunch.main(["--arch", "granite-8b", "--strategy", "pp_shardmap", "--schedule",
                        "hybrid", "--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "32",
                        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"])
    losses = out["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "'S': 2" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_00000003",
                                                                      "step_00000006"]


@pytest.mark.parametrize("strategy", ["gspmd_tp", "gspmd_pp"])
def test_launcher_gspmd_strategies_raise(strategy, tmp_path, capsys):
    """The GSPMD strategies no longer raise: each trains 2 steps through
    the step builders on the launcher's (1, 2) mesh (gspmd_pp: one stage)."""
    out = tlaunch.main(["--strategy", strategy, "--device", "cpu", "--steps", "2", "--batch",
                        "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    printed = capsys.readouterr().out
    assert f"[train] {strategy} {{'strategy': '{strategy}'" in printed
    if strategy == "gspmd_pp":
        assert "'S': 1" in printed


def test_slice_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.core.pipeline, repro_torch.models.resnet\n"
            "from repro_torch.core import calibrate\n"
            "rows = calibrate.reproduction_table()\n"
            "assert [r['setup'] for r in rows][0] == 'desktop_alone', rows\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr


if __name__ == "__main__":
    _reference_run(sys.argv[1])
