"""The port's sharding rules, strategies and input specs against the JAX
package, on the production meshes (jax ``AbstractMesh``es; the port's
shape-only ``HostMesh``es), for every arch.

Spec trees equal the reference's ``PartitionSpec``s leaf by leaf (a spec is
the tuple of the ``PartitionSpec``'s entries), over the reference's layout
and, less the leading stacked entries, over the port's per-layer (and
stage-slot) layout; per-device shard shapes equal the reference's
``NamedSharding(...).shard_shape``.  The ``meta`` init and the input specs
carry the reference's shapes and dtypes (``jax.eval_shape``).
"""
import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS, SHAPES, RunConfig, get_config, shape_applicable
from repro.core import pipeline_gspmd as jgpp
from repro.core import sharding as jsh
from repro.core import strategy as jstrat
from repro.core.partition import plan_pipeline as jplan
from repro.launch import steps as jsteps
from repro.models.api import build_model as jbuild
import repro_torch.configs as tc
from repro_torch.convert import leaves, stack_blocks
from repro_torch.core import sharding as tsh
from repro_torch.core import strategy as tstrat
from repro_torch.core.partition import plan_pipeline
from repro_torch.core.pipeline import to_pipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model

MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = jbuild(get_config(arch), RunConfig())
    return jax.eval_shape(lambda: model.init(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return build_model(tc.get_config(arch), tc.RunConfig(), device="meta").init(0)


def _flat(tree):
    """(path, leaf) pairs of a tree of dicts / lists in sorted-key order,
    leaves anything else (tensors, spec tuples, PartitionSpecs)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, v) for k in sorted(tree) for p, v in _flat(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}/{p}" if p else str(i), v) for i, t in enumerate(tree)
                for p, v in _flat(t)]
    return [("", tree)]


def _jax_flat(tree):
    return [(jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, P)))]


def _same_shapes(port, ref):
    """Port leaves (tensors) against reference leaves (ShapeDtypeStructs),
    in tree order."""
    pl, rl = [v for _, v in _flat(port)], jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == DTYPES[str(b.dtype)], (a, b)


# --- meta init and input specs ----------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_init_equals_eval_shape(arch):
    """The port's shape-only init, stacked into the reference's layout, has
    the reference's leaves, shapes and dtypes; nothing is drawn."""
    p = _port_params(arch)
    assert all(t.device.type == "meta" for t in leaves(p))
    ref = _ref_params(arch)
    stacked = tsh.reference_layout(p)
    assert sorted(stacked) == sorted(ref)
    _same_shapes(stacked, ref)
    if "blocks" in p:          # convert.stack_blocks builds the same layout on meta
        _same_shapes(stack_blocks(p)["blocks"], ref["blocks"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, tcfg = get_config(arch), tc.get_config(arch)
    for dtype in ("float32", "bfloat16"):
        rcfg = RunConfig(param_dtype=dtype, compute_dtype=dtype)
        model = build_model(tcfg, tc.RunConfig(param_dtype=dtype, compute_dtype=dtype),
                            device="cpu")
        for name, shape in SHAPES.items():
            ref = jbuild(cfg, rcfg).input_specs(shape)
            got = model.input_specs(tc.SHAPES[name])
            assert sorted(got) == sorted(ref), name
            assert all(t.device.type == "meta" for t in leaves(got))
            _same_shapes(got, ref)


# --- strategies ---------------------------------------------------------------

def test_strategy_tables_and_choices():
    assert tstrat.PP_TRAIN_ARCHS == jstrat.PP_TRAIN_ARCHS
    assert tstrat.PP_STACKED_TRAIN_ARCHS == jstrat.PP_STACKED_TRAIN_ARCHS
    assert tsh.RULE_TABLES == jsh.RULE_TABLES
    assert tuple(tsh._PARAM_RULES) == tuple(jsh._PARAM_RULES)
    for arch in ARCH_IDS:
        cfg, tcfg = get_config(arch), tc.get_config(arch)
        for name, shape in SHAPES.items():
            tshape = tc.SHAPES[name]
            for strategy in ("auto", "pp_shardmap", "gspmd_tp", "gspmd_pp"):
                assert tstrat.resolve(tcfg, tshape, tc.RunConfig(strategy=strategy)) == \
                    jstrat.resolve(cfg, shape, RunConfig(strategy=strategy))
            assert tstrat.wants_fsdp(tcfg, tshape) == jstrat.wants_fsdp(cfg, shape)
            for multi in (False, True):
                tmesh, jmesh = make_production_mesh(multi_pod=multi), MESHES[multi]
                assert tsteps.pick_grad_accum(tcfg, tshape, tmesh) == \
                    jsteps.pick_grad_accum(cfg, shape, jmesh)
                assert tsteps._serve_fsdp(tcfg, tmesh) == jsteps._serve_fsdp(cfg, jmesh)


def test_production_meshes():
    for multi, jmesh in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == dict(jmesh.shape) and mesh.size == jmesh.size


# --- param specs ----------------------------------------------------------------

def _ref_pp_shape(arch, jmesh):
    """The reference's gspmd_pp params: (S, lps, ...) stacked blocks."""
    cfg = get_config(arch)
    plan = jplan(cfg.n_layers, jmesh.shape["data"], 0, "gpipe",
                 candidates=(jmesh.shape["data"],))
    return jax.eval_shape(functools.partial(jgpp._stack_for_stages, plan=plan),
                          _ref_params(arch)), plan


def _ref_specs(arch, multi, strategy, fsdp):
    """The reference's specs as its step builders compute them: gspmd_tp
    through ``param_shardings``, gspmd_pp through the stacked-stage
    builder's own rules (leading ("stage", "layers"))."""
    jmesh = MESHES[multi]
    if strategy == "gspmd_tp":
        ps = _ref_params(arch)
        return ps, jsh.param_shardings(ps, jmesh, "gspmd_tp", fsdp=fsdp)
    ps, _ = _ref_pp_shape(arch, jmesh)
    rules = dict(jsh.RULE_TABLES["gspmd_pp"])
    if fsdp:
        rules["embed"] = "data"
    logical = jsh.param_logical_tree(ps, leading=("stage", "layers"))
    return ps, jax.tree.map(lambda leaf, log: NamedSharding(
        jmesh, jsh.spec_for(log, leaf.shape, rules, jmesh)), ps, logical)


# gspmd_pp stacks ``blocks``: whisper's encoder-decoder has none
CASES = [(a, multi, s, f) for a in ARCH_IDS for multi in (False, True)
         for s in ("gspmd_tp", "gspmd_pp") for f in (False, True)
         if s == "gspmd_tp" or not get_config(a).n_enc_layers]


@pytest.mark.parametrize("arch,multi,strategy,fsdp", CASES,
                         ids=[f"{a}-{'multi' if m else 'single'}-{s}-fsdp{int(f)}"
                              for a, m, s, f in CASES])
def test_param_specs_equal_the_reference(arch, multi, strategy, fsdp):
    mesh, jmesh = make_production_mesh(multi_pod=multi), MESHES[multi]
    rshape, rspecs = _ref_specs(arch, multi, strategy, fsdp)
    params = _port_params(arch)
    if strategy == "gspmd_pp":
        n = tc.get_config(arch).n_layers
        params = to_pipeline(params, plan_pipeline(n, 16, 0, "gpipe", candidates=(16,)))
    ref_layout, stacked = tsh.reference_shardings(params, mesh, strategy, fsdp=fsdp)
    want = _jax_flat(rspecs)
    got = _flat(stacked)
    assert len(got) == len(want)
    shapes = jax.tree.leaves(rshape)
    for (path, spec), (rpath, rs), leaf, rleaf in zip(got, want, [v for _, v in
                                                             _flat(ref_layout)], shapes):
        assert spec == tuple(rs.spec), (path, rpath)
        assert tsh.shard_shape(leaf.shape, spec, mesh) == rs.shard_shape(rleaf.shape), path
    # the port's own layout: each layer's (slot's) leaf takes its stacked
    # leaf's spec less the leading entries
    port = tsh.param_shardings(params, mesh, strategy, fsdp=fsdp)
    lead = 2 if strategy == "gspmd_pp" else 1
    by_path = dict(got)
    for path, spec in _flat(port):
        parts = path.split("/")
        if parts[0] in tsh.STACKED:
            parts = [parts[0]] + parts[1 + lead:]
            assert spec == by_path["/".join(parts)][lead:], path
        else:
            assert spec == by_path[path], path


def test_stacked_layout_keeps_the_used_set_and_trimming():
    """Hand cases of ``spec_for``: an axis used once, non-divisible dims
    replicated, trailing Nones trimmed (one and three axes)."""
    mesh, jmesh = make_production_mesh(multi_pod=True), MESHES[True]
    rules = dict(tsh.RULE_TABLES["gspmd_tp"], embed="data")
    for logical, shape in [(("vocab", "embed"), (49408, 4096)), (("embed", "q"), (4096, 100)),
                           (("q", "q"), (32, 32)), (("layers", "experts", "embed", "mlp"),
                                                    (4, 8, 6144, 32768)),
                           ((None, None), (3, 5)), (("mlp", "embed"), (16, 7))]:
        got = tsh.spec_for(logical, shape, rules, mesh)
        assert got == tuple(jsh.spec_for(logical, shape, rules, jmesh)), logical


# --- batch and cache specs -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, tcfg = get_config(arch), tc.get_config(arch)
    jmodel = jbuild(cfg, RunConfig())
    tmodel = build_model(tcfg, tc.RunConfig(), device="meta")
    for multi, jmesh in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            rspec, tspec = jmodel.input_specs(shape), tmodel.input_specs(tc.SHAPES[name])
            batch = {k: v for k, v in tspec.items() if k != "cache"}
            rbatch = {k: v for k, v in rspec.items() if k != "cache"}
            for (_, a), (_, b) in zip(_flat(tsh.batch_shardings(batch, mesh)),
                                      _jax_flat(jsh.batch_shardings(rbatch, jmesh))):
                assert a == tuple(b.spec), (name, a, b)
            if "cache" in tspec:
                got = _flat(tsh.cache_shardings(tspec["cache"], mesh, tcfg))
                want = _jax_flat(jsh.cache_shardings(rspec["cache"], jmesh, cfg))
                leaves_ = [v for _, v in _flat(tspec["cache"])]
                assert len(got) == len(want) == len(leaves_)
                for (p, a), (_, b), leaf in zip(got, want, leaves_):
                    assert a == tuple(b.spec), (name, p)
                    assert tsh.shard_shape(leaf.shape, a, mesh) == b.shard_shape(
                        tuple(leaf.shape)), (name, p)


# --- the step builders' spec trees -------------------------------------------

STEP_CASES = [("granite-8b", "decode_32k"), ("granite-8b", "prefill_32k"),
              ("whisper-small", "train_4k"), ("yi-34b", "train_4k"),
              ("llama4-scout-17b-a16e", "train_4k"), ("zamba2-7b", "decode_32k"),
              ("granite-8b", "train_4k")]


@pytest.mark.parametrize("arch,shape", STEP_CASES, ids=[f"{a}-{s}" for a, s in STEP_CASES])
def test_step_builders_match_the_reference(arch, shape):
    """``make_step`` on the single-pod mesh: the meta, donated inputs and
    every spec tree of the reference's builder (params stacked), less the
    metrics (the reference's hold per-leaf metric shardings that are all
    replicated)."""
    cfg, tcfg = get_config(arch), tc.get_config(arch)
    jmesh, mesh = MESHES[False], make_production_mesh()
    rcfg = RunConfig(unroll_layers=True)
    ref = jsteps.make_step(cfg, SHAPES[shape], rcfg, jmesh)
    got = tsteps.make_step(tcfg, tc.SHAPES[shape], tc.RunConfig(unroll_layers=True), mesh,
                           device="meta")
    assert got["meta"] == ref["meta"]
    assert got["donate_argnums"] == ref["donate_argnums"]
    n_args = len(ref["args"])
    assert len(got["args"]) == n_args
    strategy, train = got["meta"]["strategy"], SHAPES[shape].kind == "train"
    fsdp = got["meta"].get("fsdp", tsteps._serve_fsdp(tcfg, mesh))
    for i in range(n_args):
        arg, want = got["args"][i], ref["in_shardings"][i]
        if i == 1 and train:                 # the moments (the step counter replicated)
            arg, want = arg["m"], want["m"]
            assert got["in_shardings"][1]["step"] == tuple(ref["in_shardings"][1]["step"].spec)
        if (i == 0 or (i == 1 and train)) and strategy == "pp_shardmap":
            spec = tsh.pp_shardmap_shardings(got["args"][0], mesh)[1 + i]
        elif i == 0 or (i == 1 and train):   # params: the port's layout, stacked
            tp_fsdp = fsdp if i == 0 else (fsdp or True)
            _, spec = tsh.reference_shardings(arg, mesh, strategy,
                                              fsdp=tp_fsdp and strategy == "gspmd_tp")
        else:
            spec = got["in_shardings"][i]
        assert [s for _, s in _flat(spec)] == [tuple(s.spec) for _, s in _jax_flat(want)], i
    rout = ref["out_shardings"]
    gout = got["out_shardings"]
    if SHAPES[shape].kind != "train":
        assert gout[0] == tuple(rout[0].spec)
        assert [s for _, s in _flat(gout[1])] == [tuple(s.spec) for _, s in _jax_flat(rout[1])]
    else:
        assert sorted(gout[2]) == sorted(rout[2])


def test_activation_hints_registry():
    x = torch.ones(3)
    tsh.set_activation_hints(residual=("data", "model", None))
    assert tsh._ACT_HINTS["residual"] == ("data", "model", None)
    assert tsh.constrain("residual", x) is x
    tsh.clear_activation_hints()
    assert "residual" not in tsh._ACT_HINTS
    # nothing in the port reads a hint: a sequence-sharded build is refused
    with pytest.raises(ValueError, match="seq_shard"):
        tsteps.make_train_step(
            dataclasses.replace(tc.reduced_config(tc.get_config("whisper-small")), n_layers=1),
            tc.ShapeConfig("t", 16, 2, "train"), tc.RunConfig(seq_shard=True, strategy="gspmd_tp"),
            make_production_mesh(), device="cpu")
    assert not tsh._ACT_HINTS
