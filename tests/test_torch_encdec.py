"""whisper-small's encoder-decoder in the port against the JAX package, on
the CPU in fp32.

Reduced config (2 encoder and 2 decoder layers, 16 frames of width 128),
weights from the JAX init through ``params_from_jax`` (``enc_blocks`` and
``dec_blocks`` cut per layer), frames from ``FrontendPipeline``: the
encoder's rows, prefill logits and every cache leaf (``k``, ``v``, ``xk``,
``xv``) and decode logits within 1e-5; greedy tokens equal to the JAX
engine's (frames as a request's extra input, dense lanes); the loss and
every gradient within 1e-4 x max(1, max|g|), with and without remat;
``cache_from_jax`` carries a cache the port decodes from.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.convert import cache_from_jax
from repro_torch.models import encdec as ted
from repro_torch.serving.engine import ServeEngine
from test_torch_families import (LOGIT_TOL, MAX_LEN, check_loss_and_grads,
                                 check_prefill_decode, extras, models, rel, serve, tokens)

ARCH = "whisper-small"


@pytest.fixture(scope="module")
def pair():
    return models(ARCH, seed=0)


def test_params_carry_both_stacks(pair):
    model, params, tmodel, tparams = pair
    assert len(tparams["enc_blocks"]) == model.cfg.n_enc_layers == 2
    assert len(tparams["dec_blocks"]) == model.cfg.n_layers == 2
    assert set(tparams["dec_blocks"][1]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert np.array_equal(tparams["dec_blocks"][1]["xattn"]["wk"].numpy(),
                          np.asarray(params["dec_blocks"]["xattn"]["wk"][1]))
    fresh = tmodel.init(0)
    assert sorted(fresh) == sorted(tparams) and len(fresh["enc_blocks"]) == 2


def test_encoder_prefill_and_decode_match_jax(pair):
    model, params, tmodel, tparams = pair
    batch = {"tokens": tokens(0, (2, 10)), **extras(model.cfg, 2, seed=1)}
    assert batch["frames"].shape == (2, 16, 128)
    jenc = jed.encode(model.cfg, params, jnp.asarray(batch["frames"]), model.rcfg)
    tenc = ted.encode(tmodel.cfg, tparams, torch.from_numpy(batch["frames"]), tmodel.rcfg)
    assert rel(tenc, jenc) < LOGIT_TOL
    _, cj0 = model.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, MAX_LEN)
    _, ct0 = tmodel.prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                            MAX_LEN)
    for name in ("k", "v", "xk", "xv"):
        assert ct0["layers"][name].shape == cj0["layers"][name].shape
        assert rel(ct0["layers"][name], cj0["layers"][name]) < LOGIT_TOL, name
    ct, cj = check_prefill_decode(model, params, tmodel, tparams, batch, steps=5)
    assert ct["pos"].tolist() == [15, 15]
    assert rel(ct["layers"]["k"], cj["layers"]["k"]) < LOGIT_TOL


def test_decode_from_a_jax_cache(pair):
    model, params, tmodel, tparams = pair
    batch = {"tokens": tokens(2, (2, 7)), **extras(model.cfg, 2, seed=2)}
    _, cj = model.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, MAX_LEN)
    nxt = tokens(3, (2, 1))
    lj, _ = model.decode_step(params, cj, jnp.asarray(nxt))
    lt, _ = tmodel.decode_step(tparams, cache_from_jax(jax.tree.map(np.asarray, cj), "cpu"),
                               torch.from_numpy(nxt).long())
    assert rel(lt, lj) < LOGIT_TOL


def test_dense_lanes_carry_the_cross_rows(pair):
    """A lane's paste carries every leaf, the cross K/V rows included, and
    the lanes are max_len wide."""
    from repro_torch.serving.backends import DenseBackend, Reservation, lane_leaves
    _, _, tmodel, tparams = pair
    be = DenseBackend(tmodel, 3, MAX_LEN)
    assert be.token_footprint(5, 4) == MAX_LEN
    assert tuple(be.cache["layers"]["xk"].shape[1:3]) == (3, tmodel.cfg.frontend_seq)
    batch = {"tokens": torch.from_numpy(tokens(9, (2, 6))),
             "frames": torch.from_numpy(extras(tmodel.cfg, 2, seed=9)["frames"])}
    _, cache = tmodel.prefill(tparams, batch, MAX_LEN)
    be.prefill_paste(2, cache, 1, 6, 6, Reservation())
    src = lane_leaves(cache, 1)
    got = lane_leaves(be.cache, 2)
    assert sorted(got) == sorted(src) and ("layers", "xv") in got
    assert all(torch.equal(got[k], src[k]) for k in src)


def test_window_step_is_single_steps(pair):
    _, _, tmodel, tparams = pair
    batch = {"tokens": torch.from_numpy(tokens(4, (2, 6))),
             "frames": torch.from_numpy(extras(tmodel.cfg, 2, seed=4)["frames"])}
    _, c1 = tmodel.prefill(tparams, batch, MAX_LEN)
    _, c2 = tmodel.prefill(tparams, batch, MAX_LEN)
    win = torch.from_numpy(tokens(5, (2, 3))).long()
    lw, c1 = tmodel.decode_state.window_step(tparams, c1, win)
    for j in range(3):
        lj, c2 = tmodel.decode_step(tparams, c2, win[:, j:j + 1])
        assert torch.equal(lw[:, j], lj)
    assert torch.equal(c1["layers"]["k"], c2["layers"]["k"])


def test_engine_tokens_match_jax(pair):
    """Each request carries its frames; the engine prefills it alone at its
    exact length and decodes it over dense lanes, as the JAX engine does,
    and each lane's tokens equal a lone-request run's."""
    model, params, tmodel, tparams = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=3 + 4 * i) for i in range(5)]
    frames = extras(model.cfg, 5, seed=7)["frames"]
    inputs = [{"frames": f} for f in frames]
    port, eng = serve(ServeEngine, tmodel, tparams, prompts, inputs, max_new=5)
    ref, _ = serve(JaxEngine, model, params, prompts, inputs, max_new=5)
    assert eng.backend.name == "dense" and eng.backend.token_footprint(4, 5) == MAX_LEN
    assert port == ref and len(port) == 5
    snap = eng.metrics_snapshot()
    assert snap.prefill_dispatches == 5
    for i in (0, 4):
        alone, _ = serve(ServeEngine, tmodel, tparams, [prompts[i]], [inputs[i]], max_new=5,
                         max_batch=1)
        assert alone[0] == port[i]


@pytest.mark.parametrize("remat", [False, True])
def test_encdec_loss_and_grads_match_jax(remat):
    model, params, tmodel, tparams = models(ARCH, seed=1, remat=remat)
    batch = {"tokens": tokens(8, (2, 20)), **extras(model.cfg, 2, seed=8)}
    _, aux = check_loss_and_grads(model, params, tmodel, tparams, batch)
    assert aux["aux"].item() == 0.0
