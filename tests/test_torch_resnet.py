"""The port's ResNet-34, cost model, schedule tables and image pipeline
against the JAX package's, on the CPU, in fp32.

Weights come from the JAX init through ``resnet_params_from_jax``.
Tolerances: logits within 1e-4 x max(1, |ref|), the loss within 1e-5
relative, each gradient leaf within 1e-4 x max(1, max|g|) (fp32 in both
frameworks, which sum in different orders).  The cost model, the schedule
tables and the image batches must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet34 as jcfg
from repro.core import calibrate as jcal
from repro.core import schedules as jsched
from repro.data.synthetic import ImagePipeline as JImagePipeline
from repro.models import resnet as JR
from repro_torch.configs import resnet34 as tcfg
from repro_torch.convert import leaves, resnet_params_from_jax
from repro_torch.core import calibrate as tcal
from repro_torch.core import schedules as tsched
from repro_torch.data.synthetic import ImagePipeline
from repro_torch.models import resnet as TR

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

# (reference config, port config, batch): MINI, and CONFIG's widths at 64 px
CASES = {"mini": (jcfg.MINI, tcfg.MINI, 4),
         "resnet34-64px": (dataclasses.replace(jcfg.CONFIG, img_size=64),
                           dataclasses.replace(tcfg.CONFIG, img_size=64), 2)}


def _jax_init(cfg):
    """The reference's init under jit (the eager one dispatches op by op),
    and its meta, which the traced call builds as plain Python."""
    box = {}

    def init(key):
        box["meta"], params = JR.init_resnet(cfg, key)
        return params

    params = jax.jit(init)(jax.random.key(0))
    return box["meta"], params


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jc, tc, b = CASES[request.param]
    meta, params = _jax_init(jc)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, jc.img_size, jc.img_size, 3)).astype(np.float32)
    labels = rng.integers(0, jc.n_classes, size=b).astype(np.int32)
    cut = len(params) // 2

    @jax.jit
    def ref(p, x, y):
        return (JR.forward(meta, p, x), JR.forward(meta, p, x, upto=cut),
                jax.value_and_grad(JR.loss_fn)(p, meta, x, y))

    logits, hidden, (loss, grads) = ref(params, jnp.asarray(x), jnp.asarray(labels))
    tparams = resnet_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return dict(jc=jc, tc=tc, meta=meta, params=params, tparams=tparams, x=x, labels=labels,
                cut=cut, logits=np.asarray(logits), hidden=np.asarray(hidden),
                loss=float(loss), grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def _rel(got: torch.Tensor, ref: np.ndarray) -> np.ndarray:
    return np.abs(got.detach().numpy() - ref) / np.maximum(1.0, np.abs(ref))


def test_forward_matches_jax(case):
    out = TR.forward(case["meta"], case["tparams"], torch.from_numpy(case["x"]))
    assert out.shape == case["logits"].shape
    assert _rel(out, case["logits"]).max() <= LOGIT_TOL


def test_forward_cut_matches_jax(case):
    """``upto`` / ``start``: the two halves of the bench's 2-stage cut
    compose to the full forward, and the boundary matches JAX's."""
    meta, p, cut = case["meta"], case["tparams"], case["cut"]
    h = TR.forward(meta, p, torch.from_numpy(case["x"]), upto=cut)
    assert _rel(h, case["hidden"]).max() <= LOGIT_TOL
    out = TR.forward(meta, p, h, start=cut)
    assert torch.equal(out, TR.forward(meta, p, torch.from_numpy(case["x"])))


def test_loss_and_grads_match_jax(case):
    p = case["tparams"]
    flat = list(leaves(p))
    for t in flat:
        t.requires_grad_(True)
    loss = TR.loss_fn(p, case["meta"], torch.from_numpy(case["x"]),
                      torch.from_numpy(case["labels"]))
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    assert len(grads) == len(case["grads"])
    for i, (g, ref) in enumerate(zip(grads, case["grads"])):
        err = np.abs(g.numpy() - ref).max() / max(1.0, np.abs(ref).max())
        assert err <= GRAD_TOL, (i, err)


def test_block_costs_equal(case):
    meta, params = TR.init_resnet(case["tc"], torch.Generator().manual_seed(0))
    assert meta == case["meta"]
    for batch in (1, 16):
        assert (TR.block_costs(case["tc"], meta, params, batch)
                == JR.block_costs(case["jc"], case["meta"], case["params"], batch))


@pytest.mark.parametrize("what", ["conv3x3-s2-56", "stem-conv7x7-s2-32", "maxpool3x3-s2-16"])
def test_same_padding_at_stride_2(what):
    """XLA's SAME pads a stride-2 window (0, 1) or (2, 3): the odd pixel at
    the high end.  The port reproduces it; ``padding=k // 2`` does not."""
    rng = np.random.default_rng(1)
    if what.startswith("maxpool"):
        x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
        ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                    (1, 2, 2, 1), "SAME")
        got = TR._max_pool(torch.from_numpy(x))
        sym = torch.nn.functional.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                                             padding=1).permute(0, 2, 3, 1)
    else:
        k, n = (3, 56) if what.startswith("conv3") else (7, 32)
        x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
        w = rng.standard_normal((k, k, 3, 8)).astype(np.float32)
        ref = JR._conv(jnp.asarray(x), jnp.asarray(w), 2)
        got = TR._conv(torch.from_numpy(x), torch.from_numpy(w), 2)
        sym = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                         torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                                         padding=k // 2).permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == sym.shape
    assert _rel(got, ref).max() <= LOGIT_TOL
    assert _rel(sym, ref).max() > 0.1


def test_same_pad_amounts():
    assert TR.same_pad(56, 3, 2) == (0, 1)
    assert TR.same_pad(224, 7, 2) == (2, 3)
    assert TR.same_pad(112, 3, 2) == (0, 1)
    assert TR.same_pad(56, 3, 1) == (1, 1)
    assert TR.same_pad(56, 1, 2) == (0, 0)


def test_reproduction_table_and_profiles_equal():
    assert tcal.resnet_costs() == jcal.resnet_costs()
    assert tcal.reproduction_table() == jcal.reproduction_table()
    tp, jp = tcal.calibrated_profiles(), jcal.calibrated_profiles()
    assert ({k: dataclasses.asdict(v) for k, v in tp.items()}
            == {k: dataclasses.asdict(v) for k, v in jp.items()})
    assert (tcal.PAPER_MS, tcal.N_MICRO, tcal.MB) == (jcal.PAPER_MS, jcal.N_MICRO, jcal.MB)


@pytest.mark.parametrize("args", [(10, 32, 8, 0, 0, 1), (1000, 64, 16, 3, 1, 2)])
def test_image_pipeline_bit_equal(args):
    ours, ref = ImagePipeline(*args), JImagePipeline(*args)
    assert np.array_equal(ours.templates, ref.templates)
    for step in (0, 1, 17):
        (x, y), (rx, ry) = ours.batch_at(step), ref.batch_at(step)
        assert x.dtype == rx.dtype and y.dtype == ry.dtype
        assert np.array_equal(x, rx) and np.array_equal(y, ry)


@pytest.mark.parametrize("name", ["gpipe_table", "hybrid_table"])
def test_schedule_tables_equal(name):
    """Every (stages, microbatches) of ``tests/test_schedules.py``'s ranges."""
    for s in range(2, 9):
        for m in range(1, 13):
            ours, ref = getattr(tsched, name)(s, m), getattr(jsched, name)(s, m)
            assert ([(tk.stage_ops, tk.mb) for tk in ours]
                    == [(tk.stage_ops, tk.mb) for tk in ref])
            assert tsched.schedule_stats(ours, s, m) == jsched.schedule_stats(ref, s, m)
            assert tsched.render(ours) == jsched.render(ref)
            tsched.verify_dataflow(ours, s, m, name.split("_")[0])
