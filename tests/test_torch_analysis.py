"""The port's analysis package and dry-run against the JAX package's.

The analytic FLOP model is equal for every arch x shape x remat x pad; the
roofline, given the reference's TPU profile and link efficiency as
arguments (here only: the port's default is the H100 mesh), gives the
reference's rows on ok, skip and error cells, unrolled and not, with and
without the tick and wire multipliers, and the same ``best_rows`` and
hints; the HLO collective parser is equal on lines of every op, async
pairs, both replica-group forms and tuple shapes.  The port's dry-run
artifacts load in the reference's roofline, and their exact fields equal
the sums of the reference's ``NamedSharding`` shard shapes.
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.analysis import analytic as janalytic
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro.configs import ARCH_IDS, SHAPES, RunConfig, get_config
from repro.core import sharding as jsh
from repro.hw.specs import ICI_EFFICIENCY, TPU_V5E
from repro.models.api import build_model as jbuild
import repro_torch.configs as tc
from repro_torch.analysis import analytic as tanalytic
from repro_torch.analysis import hlo as thlo
from repro_torch.analysis import roofline as troof
from repro_torch.hw.specs import H100_MESH, LINK_EFFICIENCY
from repro_torch.launch import dryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_equal(arch):
    cfg, tcfg = get_config(arch), tc.get_config(arch)
    for name, shape in SHAPES.items():
        tshape = tc.SHAPES[name]
        assert tanalytic.fwd_flops(tcfg, tshape) == janalytic.fwd_flops(cfg, shape)
        for remat in (True, False):
            for pad in (0, 3):
                assert tanalytic.step_flops(tcfg, tshape, remat, pad) == \
                    janalytic.step_flops(cfg, shape, remat, pad)
                for chips in (256, 512):
                    assert tanalytic.flops_per_device(tcfg, tshape, chips, remat, pad) == \
                        janalytic.flops_per_device(cfg, shape, chips, remat, pad)


def _cells():
    """Synthetic artifacts of every kind the roofline reads."""
    base = {"status": "ok", "memory": {"peak_bytes_per_device": 12.5e9},
            "cost": {"flops_per_device": 3.1e12, "bytes_accessed_per_device": 7.7e10},
            "collectives": {"wire_bytes_per_device": 2.2e9}}
    metas = [
        ({"strategy": "gspmd_tp", "layers_multiplier": 36, "accum_multiplier": 2}, False),
        ({"strategy": "gspmd_tp", "layers_multiplier": 1, "accum_multiplier": 4}, True),
        ({"strategy": "gspmd_pp", "layers_multiplier": 3, "tick_multiplier": 47,
          "n_pad_layers": 0}, False),
        ({"strategy": "gspmd_pp", "layers_multiplier": 4, "tick_multiplier": 47,
          "n_pad_layers": 2}, True),
        ({"strategy": "pp_shardmap", "layers_multiplier": 3, "tick_multiplier": 62,
          "wire_multiplier": 62}, False),
        ({"strategy": "gspmd_tp", "layers_multiplier": 40}, False),
    ]
    cells = []
    for arch in ARCH_IDS:
        for i, (name, shape) in enumerate(SHAPES.items()):
            for mesh in ("pod16x16", "pod2x16x16"):
                meta, unrolled = metas[(i + len(cells)) % len(metas)]
                cells.append(dict(base, arch=arch, shape=name, mesh=mesh,
                                  strategy=meta["strategy"], meta=meta, unrolled=unrolled))
        cells.append({"arch": arch, "shape": "long_500k", "mesh": "pod16x16", "status": "skip",
                      "reason": "needs sub-quadratic attention " * 5})
        cells.append({"arch": arch, "shape": "train_4k", "mesh": "pod2x16x16",
                      "strategy": "gspmd_tp", "status": "error", "error": "RuntimeError: " + "x" * 90})
    return cells


def test_roofline_rows_equal_the_reference_given_its_profile():
    cells = _cells()
    for cell in cells:
        got = troof.row_from_cell(cell, TPU_V5E, ICI_EFFICIENCY)
        ref = jroof.row_from_cell(cell)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), cell["arch"]
        assert got.fraction_of_roofline() == ref.fraction_of_roofline()
        assert troof.improvement_hint(got) == jroof.improvement_hint(ref)
    got = troof.best_rows(cells, TPU_V5E, ICI_EFFICIENCY)
    ref = jroof.best_rows(cells)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(ref[key]), key


def test_roofline_default_is_the_h100_mesh():
    cell = _cells()[0]
    row = troof.row_from_cell(cell)
    assert row == troof.row_from_cell(cell, H100_MESH, LINK_EFFICIENCY)
    assert H100_MESH.flops == 989e12 and H100_MESH.mem_bw == 3.35e12
    assert H100_MESH.mem_bytes == 80e9 and H100_MESH.link_bw == 50e9
    assert row.collective_s == pytest.approx(2.2e9 * 72 / (50e9 * LINK_EFFICIENCY))


HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = f32[4096,1024]{1,0} all-reduce(f32[4096,1024]{1,0} %g), replica_groups=[16,16]<=[256], to_apply=%add
  %rs = f32[256,1024]{1,0} reduce-scatter(f32[4096,1024]{1,0} %g), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = bf16[8,512,128]{2,1,0} all-to-all(bf16[8,512,128]{2,1,0} %t), replica_groups=[32,8]<=[256]
  %cp = bf16[2,64,4096]{2,1,0} collective-permute(bf16[2,64,4096]{2,1,0} %b), source_target_pairs={{0,1},{1,2}}
  %ars = (f32[1024]{0}, f32[1024]{0}) all-reduce-start(f32[1024]{0} %p), replica_groups={{0,1}}
  %ard = f32[1024]{0} all-reduce-done((f32[1024]{0}, f32[1024]{0}) %ars)
  %ags = (bf16[4,64]{1,0}, bf16[64,64]{1,0}) all-gather-start(bf16[4,64]{1,0} %q), replica_groups=[16,16]<=[256]
  %agd = bf16[64,64]{1,0} all-gather-done((bf16[4,64]{1,0}, bf16[64,64]{1,0}) %ags)
  %tup = (f32[8]{0}, s32[4]{0}, pred[2]{0}) all-reduce(f32[8]{0} %u, s32[4]{0} %v, pred[2]{0} %w), replica_groups={{0,1,2}}
  %cps = (bf16[2,8]{1,0}, bf16[2,8]{1,0}, u32[]) collective-permute-start(bf16[2,8]{1,0} %z), source_target_pairs={{0,1}}
  %add = f32[] add(f32[] %a, f32[] %b)
"""


def test_parse_collectives_equals_the_reference():
    for n in (256, 512):
        got, ref = thlo.parse_collectives(HLO, n), jhlo.parse_collectives(HLO, n)
        assert got.ops == ref.ops and len(got.ops) == 9
        assert got.wire_bytes == ref.wire_bytes and got.payload_bytes == ref.payload_bytes
        assert got.by_kind() == ref.by_kind()
    assert {o["op"] for o in got.ops} == {"all-gather", "all-reduce", "reduce-scatter",
                                          "all-to-all", "collective-permute"}
    for name in ("all-reduce", "all-gather-start", "add"):
        assert thlo.count_op(HLO, name) == jhlo.count_op(HLO, name)


# --- the dry-run ------------------------------------------------------------

DRY_CELLS = [("granite-8b", "train_4k"), ("llama4-scout-17b-a16e", "train_4k"),
             ("whisper-small", "train_4k"), ("granite-8b", "decode_32k"),
             ("grok-1-314b", "prefill_32k"), ("granite-8b", "long_500k"),
             ("zamba2-7b", "long_500k")]


@pytest.fixture(scope="module")
def dry_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    flags = os.environ.get("XLA_FLAGS")
    cells = [dryrun.run_cell(a, s, mp, out_dir=out, verbose=False)
             for a, s in DRY_CELLS for mp in (False, True)]
    assert os.environ.get("XLA_FLAGS") == flags         # the dry-run leaves it alone
    return out, cells


def test_dryrun_artifacts_load_in_the_reference_roofline(dry_cells):
    out, cells = dry_cells
    loaded = jroof.load_cells(out)
    assert len(loaded) == len(cells)
    statuses = sorted(c["status"] for c in loaded)
    assert statuses.count("skip") == 2 and statuses.count("error") == 0
    strategies = {c["arch"]: c.get("strategy") for c in loaded if c["shape"] == "train_4k"}
    assert strategies == {"granite-8b": "pp_shardmap", "llama4-scout-17b-a16e": "gspmd_pp",
                          "whisper-small": "gspmd_tp"}
    for cell in loaded:
        ref = jroof.row_from_cell(cell)
        got = troof.row_from_cell(cell, TPU_V5E, ICI_EFFICIENCY)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        h100 = troof.row_from_cell(cell)
        if cell["status"] == "ok":
            assert h100.step_s > 0 and h100.dominant in ("compute", "memory", "collective")
            assert set(cell) >= {"status", "strategy", "memory", "cost", "collectives", "meta",
                                 "unrolled", "fits_h100_80gb", "estimates"}
            # the per-body fields times the roofline's multiplier are the totals
            mult = jroof._multiplier(cell["meta"], cell["unrolled"])
            assert cell["cost"]["bytes_accessed_per_device"] * mult == pytest.approx(
                cell["totals"]["bytes_accessed_per_device"])
    assert len(jroof.best_rows(loaded)) == len(troof.best_rows(loaded))


def _ref_shard_bytes(tree, shardings):
    return sum(math.prod(s.shard_shape(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
                   shardings, is_leaf=lambda x: isinstance(x, NamedSharding))))


@pytest.mark.parametrize("multi", [False, True])
def test_dryrun_exact_bytes_equal_the_reference_shards(dry_cells, multi):
    """whisper-small's gspmd_tp train cell and granite's decode cell: params
    (and ZeRO-1 moments, batch, cache) per device are the sums of the
    reference's shard shapes."""
    _, cells = dry_cells
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi else \
        AbstractMesh((16, 16), ("data", "model"))
    name = "pod2x16x16" if multi else "pod16x16"
    cell = next(c for c in cells if (c["arch"], c["shape"], c["mesh"]) ==
                ("whisper-small", "train_4k", name))
    cfg = get_config("whisper-small")
    model = jbuild(cfg, RunConfig())
    ps = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    params = _ref_shard_bytes(ps, jsh.param_shardings(ps, mesh, "gspmd_tp"))
    m32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32), ps)
    moments = 2 * _ref_shard_bytes(m32, jsh.param_shardings(ps, mesh, "gspmd_tp", fsdp=True))
    batch_specs = model.input_specs(SHAPES["train_4k"])
    batch = _ref_shard_bytes(batch_specs, jsh.batch_shardings(batch_specs, mesh))
    assert cell["totals"]["params_bytes_per_device"] == params
    assert cell["memory"]["argument_bytes"] == params + moments + batch
    assert cell["memory"]["alias_bytes"] == params + moments
    dec = next(c for c in cells if (c["arch"], c["shape"], c["mesh"]) ==
               ("granite-8b", "decode_32k", name))
    cfg = get_config("granite-8b")
    model = jbuild(cfg, RunConfig())
    ps = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    specs = model.input_specs(SHAPES["decode_32k"])
    cache = _ref_shard_bytes(specs["cache"], jsh.cache_shardings(specs["cache"], mesh, cfg))
    toks = _ref_shard_bytes(specs["tokens"], jsh.batch_shardings(specs["tokens"], mesh))
    serve = _ref_shard_bytes(ps, jsh.param_shardings(ps, mesh, "gspmd_tp", fsdp=False))
    assert dec["memory"]["argument_bytes"] == serve + cache + toks
    assert dec["memory"]["alias_bytes"] == cache


def test_dryrun_cli_sweeps_and_reports(tmp_path, capsys):
    out = dryrun.main(["--arch", "rwkv6-1.6b", "--mesh", "both", "--out", str(tmp_path),
                       "--quiet"])
    cells = out["cells"]
    assert len(cells) == 8 and len(list(tmp_path.glob("*.json"))) == 8
    printed = capsys.readouterr().out
    assert "[dryrun] done: 8 ok, 0 failed, 0 skipped" in printed
    one = json.loads(next(tmp_path.glob("rwkv6-1.6b__train_4k__pod16x16*.json")).read_text())
    assert one["strategy"] == "pp_shardmap" and one["fits_h100_80gb"] is True
