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
    for arch in ("granite-8b", "rwkv6-1.6b", "zamba2-7b"):
        full = dataclasses.asdict(get_config(arch))
        assert full == dataclasses.asdict(tconfigs.get_config(arch))
        assert dataclasses.asdict(reduced_config(get_config(arch))) == dataclasses.asdict(
            tconfigs.reduced_config(tconfigs.get_config(arch)))
    assert tconfigs.ARCH_IDS == ["whisper-small", "zamba2-7b", "mistral-nemo-12b", "yi-34b",
                                 "granite-8b", "command-r-35b", "llama4-scout-17b-a16e",
                                 "grok-1-314b", "rwkv6-1.6b", "internvl2-1b"]


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
    """rwkv builds, trains and serves: its prefill, decode step and cache
    give finite logits and its recurrent state, with no batched prefill
    and no pool; granite's loss is finite; moe and the pure SSM build (an
    MoE granite pools but takes no batched prefill; the SSM is recurrent);
    a frontend batch puts its rows ahead of the tokens."""
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32")
    moe = tbuild_model(dataclasses.replace(tcfg, family="moe", n_experts=4, top_k=2), trc,
                       device="cpu")
    assert moe.decode_state.poolable and moe.decode_state.batched_prefill is None
    ssm = tbuild_model(dataclasses.replace(tcfg, family="ssm", ssm_state=16, ssm_headdim=32),
                       trc, device="cpu")
    assert ssm.decode_state.kind == "recurrent" and not ssm.decode_state.poolable
    rwkv = tbuild_model(tconfigs.reduced_config(tconfigs.get_config("rwkv6-1.6b")), trc,
                        device="cpu")
    ds = rwkv.decode_state
    assert ds.kind == "recurrent" and not ds.poolable and ds.batched_prefill is None
    toks = torch.as_tensor(_tokens(2, (2, 12)))
    rp = rwkv.init(0)
    with torch.no_grad():
        logits, cache = rwkv.prefill(rp, {"tokens": toks}, 16)
        logits2, cache2 = rwkv.decode_step(rp, cache, toks[:, :1])
    assert logits.shape == logits2.shape == (2, 512) and torch.isfinite(logits2).all()
    assert cache2["pos"].tolist() == [13, 13]
    empty = rwkv.init_cache(2, 16)
    assert set(empty["layers"]) == {"S", "last", "last_c"}
    assert {k: tuple(v.shape) for k, v in empty["layers"].items()} == {
        k: tuple(v.shape) for k, v in cache2["layers"].items()}
    model = tbuild_model(tcfg, trc, device="cpu")
    loss, aux = model.loss(model.init(0), {"tokens": toks})
    assert loss.shape == () and torch.isfinite(loss) and float(aux["aux"]) == 0.0
    assert torch.isfinite(rwkv.loss(rwkv.init(0), {"tokens": toks})[0])
    params = model.init(0)
    rows = torch.zeros((2, 4, 128))
    fl, faux = model.loss(params, {"tokens": toks, "frontend": rows})
    assert torch.isfinite(fl) and float(faux["aux"]) == 0.0
    _, fcache = model.prefill(params, {"tokens": toks, "frontend": rows}, 32)
    assert fcache["pos"].tolist() == [16, 16]
    with pytest.raises(ValueError, match="param_dtype"):
        tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32"), device="cpu")
    assert model.device == torch.device("cpu")
    chunked = tbuild_model(dataclasses.replace(tcfg, attention="chunked_local",
                                               chunk_size=16), trc, device="cpu")
    assert chunked.decode_state.batched_prefill is None
    assert model.decode_state.batched_prefill is not None


@pytest.mark.parametrize("kv_blocks", [None, 12], ids=["dense", "paged"])
def test_serving_params_that_require_grad_builds_no_graph(kv_blocks):
    """Params straight from a trainer (requires_grad) serve the same tokens
    as detached ones and save no tensor for a backward."""
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    _, tcfg = _cfgs()
    model = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                  compute_dtype="float32"), device="cpu")
    params = model.init(0)
    prompts = [_tokens(3, (9,)), _tokens(4, (5,))]

    def serve(p):
        eng = ServeEngine(model, p, max_batch=2, max_len=32,
                          config=EngineConfig(kv_blocks=kv_blocks, kv_block_size=4))
        for pr in prompts:
            eng.submit(pr, max_new=4)
        return [r.out_tokens for r in eng.run_until_drained()], eng

    want, _ = serve(params)
    for t in jax.tree.leaves(params):
        t.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(1) or t, lambda t: t):
        got, eng = serve(params)
    assert got == want
    assert not saved
    assert not any(t.requires_grad for t in jax.tree.leaves(eng.backend.cache))


def test_move_params_keeps_values():
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32")
    params = tbuild_model(tcfg, trc, device="cpu").init(0)
    moved = move_params(params, "cpu")
    assert torch.equal(moved["blocks"][1]["attn"]["wo"], params["blocks"][1]["attn"]["wo"])


def _pool_setup(bs=4, max_blocks=8):
    """Two prompts whose first block is the same tokens, their prefill K/V
    pasted into a pool: lane 0 on blocks [4, 2, 9], lane 1 sharing block 4
    and then on [7]; growth blocks for 4 decode steps after them, sink
    entries past."""
    shared = _tokens(5, (bs,))
    p0 = np.concatenate([shared, _tokens(6, (7,))])               # 11 tokens
    p1 = np.concatenate([shared, _tokens(7, (2,))])               # 6 tokens
    tables = np.zeros((2, max_blocks), np.int32)
    tables[0, :4] = [4, 2, 9, 3]
    tables[1, :3] = [4, 7, 5]
    return (p0, p1), tables


def _paste(pool, lane_kv, table, lo, hi, bs):
    """pool (L, NB, bs, G, D) numpy; write positions lo..hi-1 of one lane's
    dense K/V (L, span, G, D) at the table's slots."""
    for p in range(lo, hi):
        pool[:, table[p // bs], p % bs] = lane_kv[:, p]


def test_pool_decode_step_matches_jax_and_dense(pair):
    """lm_decode_step_pool on a hand-built table with a block shared by two
    lanes: logits within 1e-5 of the JAX pool step (with its Pallas kernel in
    interpret mode, or its gather path) with identical argmax over 4 steps,
    and within 1e-5 of the port's own dense decode of the same sequences."""
    model, params, tmodel, tparams = pair
    bs, nb = 4, 10
    (p0, p1), tables = _pool_setup(bs)
    v = tmodel.cfg.vocab_size
    pools = {k: np.zeros((tmodel.cfg.n_layers, nb + 1, bs, tmodel.cfg.n_kv_heads,
                          tmodel.cfg.head_dim), np.float32) for k in ("k", "v")}
    dense_t, first = [], []
    for lane, (prompt, lo) in enumerate(((p0, 0), (p1, bs))):     # lane 1 skips the shared block
        lt, ct = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt[None]).long()},
                                MAX_LEN)
        for k in ("k", "v"):
            _paste(pools[k], ct["layers"][k][:, 0].numpy(), tables[lane], lo, len(prompt), bs)
        dense_t.append(ct)
        first.append(int(torch.argmax(lt[0, :v])))
    pos = np.array([len(p0), len(p1)], np.int32)
    jcache = {"layers": {k: jnp.asarray(a) for k, a in pools.items()}, "pos": jnp.asarray(pos)}
    tcache = tmodel.decode_state.pool_init(2, nb, bs)
    for k in ("k", "v"):
        tcache["layers"][k].copy_(torch.from_numpy(pools[k]))
    tcache["pos"].copy_(torch.from_numpy(pos))
    bt = torch.from_numpy(tables)
    toks = np.array([first], np.int32).T
    for _ in range(4):
        lj, jcache = model.decode_state.pool_step(params, jcache, jnp.asarray(toks),
                                                  jnp.asarray(tables))
        lt, tcache = tmodel.decode_state.pool_step(tparams, tcache,
                                                   torch.as_tensor(toks).long(), bt)
        assert _close(lt, lj) < LOGIT_TOL
        nxt = torch.argmax(lt[:, :v], -1)
        assert np.array_equal(nxt.numpy(), np.asarray(jnp.argmax(lj[:, :v], -1)))
        for lane in range(2):
            ld, dense_t[lane] = tmodel.decode_step(tparams, dense_t[lane],
                                                   torch.as_tensor(toks[lane:lane + 1]).long())
            assert _close(lt[lane:lane + 1], ld.numpy()) < LOGIT_TOL
        toks = nxt.numpy().astype(np.int32)[:, None]
    assert tmodel.decode_state.poolable
    # the shared block was never written by lane 1's decode steps
    assert np.array_equal(tcache["layers"]["k"][:, 4].numpy(), pools["k"][:, 4])


def test_pool_step_writes_idle_lanes_into_the_sink():
    _, tcfg = _cfgs()
    trc = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    tmodel = tbuild_model(tcfg, trc, device="cpu")
    params = tmodel.init(0)
    cache = tmodel.decode_state.pool_init(3, 6, 4)
    assert tuple(cache["layers"]["k"].shape) == (tcfg.n_layers, 7, 4, tcfg.n_kv_heads,
                                                 tcfg.head_dim)
    tables = torch.zeros((3, 4), dtype=torch.int32)
    tables[1, 0] = 5                                  # lanes 0 and 2 idle
    _, cache = tmodel.decode_state.pool_step(params, cache, torch.zeros((3, 1),
                                                                        dtype=torch.int64),
                                             tables)
    written = cache["layers"]["k"].abs().sum(dim=(0, 3, 4)) > 0       # (NB+1, bs)
    assert written[5, 0] and written[0, 0]
    assert int(written.sum()) == 2                    # lane 1's row and one sink row
    assert cache["pos"].tolist() == [1, 1, 1]
