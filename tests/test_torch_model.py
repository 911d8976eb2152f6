"""Reduced granite in the port against the JAX model, same weights, fp32.

Weights come from the JAX init through ``params_from_jax``; prompts from a
seeded numpy generator.  Tolerance: 1e-5 on logits of magnitude ~10 (the
two frameworks sum in different orders; measured differences ~1.5e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
import repro_torch.configs as tconfigs
from repro_torch.convert import move_params, params_from_jax, tensor_from_numpy
from repro_torch.models.api import build_model as tbuild_model

LOGIT_TOL = 1e-5
MAX_LEN = 48


def _cfgs(n_layers=2):
    cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                               n_layers=n_layers)
    return cfg, tcfg


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "kernels"])
def pair(request):
    """(jax model, jax params, port model, port params) for one JAX
    use_kernels setting: with kernels on, the JAX side runs its Pallas
    kernels in interpret mode.  The port always routes through
    ``kernels.ops``, whose CPU tensors take the plain versions."""
    uk = request.param
    cfg, tcfg = _cfgs()
    rc = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                   use_kernels=uk)
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    model = build_model(cfg, rc)
    params = model.init(jax.random.key(0))
    tmodel = tbuild_model(tcfg, trc, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return model, params, tmodel, tparams


def _close(port: torch.Tensor, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(np.int32)


def test_configs_are_copies():
    cfg, tcfg = _cfgs(4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    full = dataclasses.asdict(get_config("granite-8b"))
    assert full == dataclasses.asdict(tconfigs.get_config("granite-8b"))
    assert tconfigs.ARCH_IDS == ["granite-8b"]


def test_prefill_and_decode_logits_match_jax(pair):
    model, params, tmodel, tparams = pair
    toks = _tokens(0, (2, 20))
    lj, cj = model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    lt, ct = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks).long()}, MAX_LEN)
    assert _close(lt, lj) < LOGIT_TOL
    assert _close(ct["layers"]["k"], cj["layers"]["k"]) < LOGIT_TOL
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(lj[:, :512], -1)).astype(np.int32)[:, None]
        assert np.array_equal(torch.argmax(lt[:, :512], -1).numpy(), nxt[:, 0])
        lj, cj = model.decode_step(params, cj, jnp.asarray(nxt))
        lt, ct = tmodel.decode_step(tparams, ct, torch.as_tensor(nxt).long())
        assert _close(lt, lj) < LOGIT_TOL
    assert _close(ct["layers"]["v"], cj["layers"]["v"]) < LOGIT_TOL


def test_padded_prefill_matches_jax(pair):
    model, params, tmodel, tparams = pair
    toks = _tokens(1, (3, 24))
    lens = np.array([5, 24, 13], np.int32)
    lj, cj = model.decode_state.batched_prefill(params, {"tokens": jnp.asarray(toks)},
                                                jnp.asarray(lens), MAX_LEN)
    lt, ct = tmodel.decode_state.batched_prefill(
        tparams, {"tokens": torch.as_tensor(toks).long()}, torch.as_tensor(lens), MAX_LEN)
    assert _close(lt, lj) < LOGIT_TOL
    assert np.array_equal(torch.argmax(lt, -1).numpy(), np.asarray(jnp.argmax(lj, -1)))
    assert np.array_equal(ct["pos"].numpy(), lens)
    # a padded lane's logits equal an exact-length prefill of that prompt
    l1, _ = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks[:1, :5]).long()}, MAX_LEN)
    assert _close(lt[:1], l1.numpy()) < LOGIT_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_full_sequence_attention_matches_jax(pair, causal):
    from repro.models.attention import attention as jax_attention
    from repro_torch.models.attention import attention as port_attention
    model, params, tmodel, tparams = pair
    x = np.random.default_rng(2).standard_normal((2, 24, model.cfg.d_model)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    ref = jax_attention(layer0, model.cfg, jnp.asarray(x), causal=causal,
                        use_kernels=model.rcfg.use_kernels)
    got = port_attention(tparams["blocks"][0]["attn"], tmodel.cfg, torch.from_numpy(x),
                         causal=causal)
    assert _close(got, ref) < LOGIT_TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_attention_always_routes_through_ops(monkeypatch, use_kernels):
    """Whatever ``RunConfig.use_kernels`` says, prefill and decode attention
    call ``kernels.ops`` (kernel on CUDA tensors, plain version on CPU)."""
    from repro_torch.kernels import ops
    calls = {"flash_attention": 0, "decode_attention": 0}

    def counted(name):
        real = getattr(ops, name)

        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f
    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32",
                             use_kernels=use_kernels)
    tmodel = tbuild_model(tcfg, trc, device="cpu")
    params = tmodel.init(0)
    _, cache = tmodel.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                              MAX_LEN)
    tmodel.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.int64))
    assert calls == {"flash_attention": tcfg.n_layers, "decode_attention": tcfg.n_layers}


def test_params_from_jax_moves_bf16_bit_exact():
    cfg, tcfg = _cfgs()
    model = build_model(cfg, RunConfig(remat=False))             # bf16 params
    tree = jax.tree.map(np.asarray, model.init(jax.random.key(1)))
    port = params_from_jax(tree, device="cpu")
    assert len(port["blocks"]) == cfg.n_layers
    wq = port["blocks"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    ref = tree["blocks"]["attn"]["wq"][1]
    assert ref.dtype == ml_dtypes.bfloat16
    assert np.array_equal(wq.view(torch.int16).numpy(), ref.view(np.int16))
    assert torch.equal(port["embed"]["tok"].float(),
                       torch.from_numpy(tree["embed"]["tok"].astype(np.float32)))
    assert tensor_from_numpy(np.zeros(3, np.float32)).dtype == torch.float32


def test_port_init_shapes_match_jax_and_are_seeded():
    cfg, tcfg = _cfgs()
    rc = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    jtree = jax.tree.map(np.asarray, build_model(cfg, rc).init(jax.random.key(0)))
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    tmodel = tbuild_model(tcfg, trc, device="cpu")
    a, b = tmodel.init(7), tmodel.init(7)
    conv = params_from_jax(jtree, device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(a) == shapes(conv)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    w = a["blocks"][0]["mlp"]["wi"]
    # truncated normal (-2, 2) x d_model ** -0.5
    assert float(w.abs().max()) <= 2 * tcfg.d_model ** -0.5 + 1e-6
    assert abs(float(w.std()) - 0.88 * tcfg.d_model ** -0.5) < 0.01


def test_build_model_gates_unported_families_and_training():
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32")
    for kw in (dict(family="moe", n_experts=4, top_k=2), dict(family="ssm", ssm_state=16),
               dict(rwkv=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbuild_model(dataclasses.replace(tcfg, **kw), trc, device="cpu")
    model = tbuild_model(tcfg, trc, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.loss({}, {})
    with pytest.raises(ValueError, match="param_dtype"):
        tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32"), device="cpu")
    assert model.device == torch.device("cpu")
    chunked = tbuild_model(dataclasses.replace(tcfg, attention="chunked_local",
                                               chunk_size=16), trc, device="cpu")
    assert chunked.decode_state.batched_prefill is None
    assert model.decode_state.batched_prefill is not None


def test_move_params_keeps_values():
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32")
    params = tbuild_model(tcfg, trc, device="cpu").init(0)
    moved = move_params(params, "cpu")
    assert torch.equal(moved["blocks"][1]["attn"]["wo"], params["blocks"][1]["attn"]["wo"])
