"""The port's MoE (llama4-scout and grok-1) against the JAX package, and the
chunked-local ring, on the CPU in fp32.

Routing (top-k picks, gates, capacity drops) and the balance loss equal the
reference's; the index dispatch equals ``apply_moe_plain`` (the reference's
one-hot einsum); the group split and capacity hold at a 9000-token prompt;
the reduced models' logits (1e-5), greedy tokens (dense lanes; grok over the
paged pool too), loss with aux and gradients (1e-4 x max(1, max|g|)) match;
a grok stage split equals the unsplit model.  Weights come from the JAX
init through ``params_from_jax``.

The chunked-local case (``test_chunked_local_tail``) records a fault of the
reference that the port does not copy (ROADMAP §3): after a prompt longer
than the chunk, the reference's prefill keeps the tail at slots 0..span-1
while its decode writes at ``pos % span``, so decode overwrites the wrong
key.  The port puts each position p at slot ``p % span``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import moe as jmoe
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.api import split_stage_params, stage_model
from repro_torch.models.attention import _proj_qkv
from repro_torch.models.common import apply_rope, embed_tokens, rmsnorm
from repro_torch.models.lm import head_logits
from repro_torch.serving.engine import EngineConfig, ServeEngine
from test_torch_families import (LOGIT_TOL, check_loss_and_grads, check_prefill_decode,
                                 models, np_tree, rel, serve, tokens)

MOE_ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")


def _moe_pair(arch, seed=0, edit=None):
    """(jax cfg, jax moe params, port cfg, port moe params) of one layer."""
    cfg = reduced_config(get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    if edit is not None:
        cfg, tcfg = edit(cfg), edit(tcfg)
    p = jmoe.init_moe(jax.random.key(seed), cfg, jnp.float32)
    return cfg, p, tcfg, params_from_jax(np_tree({"moe": p}), device="cpu")["moe"]


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_drops_and_aux_match_reference(arch):
    """Top-k picks and raw-probability gates by the reference's own
    ``_top_k_gating``; with a tight capacity some picks are dropped, and
    the output and aux equal the reference's ``apply_moe``."""
    cfg, p, tcfg, tp = _moe_pair(arch)
    x = _x(1, (2, 40, cfg.d_model))
    kw = dict(capacity_factor=0.5, group_size=16)
    g, n = tmoe.groups(80, 16)
    assert (g, n) == (5, 16)
    rt = tmoe.route(tp, tcfg, torch.from_numpy(x).reshape(g, n, -1), 0.5)
    logits = jnp.asarray(x).reshape(g, n, -1) @ p["router"]
    jgates, jmask = jmoe._top_k_gating(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    assert np.array_equal(rt.mask.numpy(), np.asarray(jmask))
    assert rel(rt.gates, jgates) < 1e-6
    assert rt.cap == int(max(cfg.top_k, 0.5 * n * cfg.top_k / cfg.n_experts))
    assert int(rt.keep.sum()) < int(rt.mask.sum())              # capacity drops happen
    assert int(rt.mask.sum()) == g * n * cfg.top_k
    jy, jaux = jmoe.apply_moe(p, cfg, jnp.asarray(x), **kw)
    y, aux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x), **kw)
    assert rel(y, jy) < LOGIT_TOL
    assert abs(float(aux) - float(jaux)) < 1e-6
    # dropped picks add nothing: a token whose every pick was dropped gets
    # the shared expert alone (llama4) or zero (grok)
    dropped = (rt.mask & ~rt.keep).any(-1) & ~rt.keep.any(-1)
    if dropped.any():
        rows = y.reshape(g, n, -1)[dropped]
        shared = (tmoe.apply_mlp(tp["shared"], torch.from_numpy(x).reshape(g, n, -1)[dropped],
                                 tcfg.act) if "shared" in tp else torch.zeros_like(rows))
        assert torch.allclose(rows, shared, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_index_dispatch_equals_the_one_hot_einsum(arch, dtype):
    cfg, p, tcfg, tp = _moe_pair(arch, seed=3)
    tp = {k: (v if k == "router" else
              {kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dtype))
          for k, v in tp.items()}
    x = torch.from_numpy(_x(4, (3, 50, cfg.d_model))).to(dtype)
    for kw in (dict(), dict(capacity_factor=0.6, group_size=32), dict(group_size=3)):
        y, aux = tmoe.apply_moe(tp, tcfg, x, **kw)
        yp, auxp = tmoe.apply_moe_plain(tp, tcfg, x, **kw)
        assert y.dtype == yp.dtype == dtype and float(aux) == float(auxp)
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        assert rel(y, yp.float().numpy()) < tol


def test_params_from_jax_keeps_the_router_fp32_in_a_bf16_tree():
    """The expert leaves cross as (E, D, F) per layer, bit for bit; the
    router stays fp32 (the reference draws it in fp32 whatever the dtype)."""
    from repro.configs import RunConfig
    from repro.models.api import build_model
    model = build_model(dataclasses.replace(reduced_config(get_config("grok-1-314b")),
                                            n_layers=2), RunConfig(remat=False))
    tree = np_tree(model.init(jax.random.key(2)))
    port = params_from_jax(tree, device="cpu")
    moe = port["blocks"][1]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["wi"].dtype == torch.bfloat16
    assert tuple(moe["wi"].shape) == (4, 128, 256) and tuple(moe["wo"].shape) == (4, 256, 128)
    assert np.array_equal(moe["wg"].view(torch.int16).numpy(),
                          tree["blocks"]["moe"]["wg"][1].view(np.int16))
    assert np.array_equal(moe["router"].numpy(), tree["blocks"]["moe"]["router"][1])
    fresh = tmoe.init_moe(torch.Generator().manual_seed(0), model.cfg, torch.bfloat16)
    assert fresh["router"].dtype == torch.float32 and sorted(fresh) == sorted(moe)


def test_group_split_and_capacity_at_a_9000_token_prompt():
    """llama4's long prompt: 9000 tokens split into 2 groups of 4500, 351
    slots per expert (``int`` truncation of 351.5625); output and aux equal
    the reference's at a narrow width."""
    assert tmoe.groups(9000, 4096) == (2, 4500)
    assert tmoe.groups(9001, 4096) == (1, 9001)
    assert tmoe.groups(12288, 4096) == (3, 4096)
    assert tmoe.capacity(4500, 1, 16, 1.25) == 351
    assert tmoe.capacity(8, 1, 16, 1.25) == 1 and tmoe.capacity(16, 2, 8, 1.25) == 5
    assert tmoe.capacity(3, 2, 2, 1.25) == 3                      # capped at the group
    edit = lambda c: dataclasses.replace(c, d_model=8, d_ff=16, n_experts=16, top_k=1)
    cfg, p, tcfg, tp = _moe_pair("llama4-scout-17b-a16e", seed=5, edit=edit)
    x = _x(6, (1, 9000, 8))
    jy, jaux = jmoe.apply_moe(p, cfg, jnp.asarray(x))
    y, aux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x))
    rt = tmoe.route(tp, tcfg, torch.from_numpy(x).reshape(2, 4500, 8))
    assert rt.cap == 351 and int(rt.keep.sum()) < 9000
    assert rel(y, jy) < LOGIT_TOL and abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_models_match_jax(arch):
    """Prefill (exact length, one request at a time) and decode logits, and
    greedy tokens against the JAX engine: dense lanes, and for grok the
    paged pool.  Lanes share expert capacity at a decode step, as in the
    reference, so both engines run the same schedule."""
    model, params, tmodel, tparams = models(arch)
    assert tmodel.decode_state.batched_prefill is None
    check_prefill_decode(model, params, tmodel, tparams, {"tokens": tokens(7, (2, 20))})
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, size=4 + 5 * i) for i in range(4)]
    port, eng = serve(ServeEngine, tmodel, tparams, prompts)
    ref, _ = serve(JaxEngine, model, params, prompts)
    assert eng.backend.name == "dense" and port == ref
    if tmodel.decode_state.poolable:
        port_p, eng = serve(ServeEngine, tmodel, tparams, prompts,
                            config=EngineConfig(kv_blocks=24, kv_block_size=8))
        ref_p, _ = serve(JaxEngine, model, params, prompts,
                         config=JaxEngineConfig(kv_blocks=24, kv_block_size=8))
        assert eng.backend.name == "paged" and port_p == ref_p


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_with_aux_and_grads_match_jax(arch):
    model, params, tmodel, tparams = models(arch, seed=1)
    _, aux = check_loss_and_grads(model, params, tmodel, tparams, {"tokens": tokens(9, (2, 40))})
    assert aux["aux"].item() > 0


def test_grok_stage_split_equals_the_unsplit_model():
    """grok cut into two stages: prefill and decode composed over the
    stages are ``torch.equal`` to the full model, and within 1e-5 of JAX."""
    model, params, tmodel, tparams = models("grok-1-314b", n_layers=3)
    toks = tokens(10, (2, 14))
    stages = [stage_model(tmodel, 0, 1), stage_model(tmodel, 1, 3)]
    sparams = split_stage_params(tmodel, tparams, (1,))
    want, cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 32)
    h, c0 = stages[0].prefill(sparams[0], {"tokens": torch.from_numpy(toks)}, 32)
    got, c1 = stages[1].prefill(sparams[1], {"hidden": h}, 32)
    assert torch.equal(got, want)
    jwant, _ = model.prefill(params, {"tokens": jnp.asarray(toks)}, 32)
    assert rel(got, jwant) < LOGIT_TOL
    nxt = torch.argmax(want[:, :512], -1)[:, None]
    want, _ = tmodel.decode_step(tparams, cache, nxt)
    h, _ = stages[0].decode_step(sparams[0], c0, nxt)
    got, _ = stages[1].decode_step(sparams[1], c1, h)
    assert torch.equal(got, want)


# --- the chunked-local ring -----------------------------------------------------

SPAN = 32           # reduced llama4's chunk


def _ring_pair():
    return models("llama4-scout-17b-a16e", n_layers=1, seed=4)


def _layer0_k(tmodel, tparams, toks):
    """Layer 0's rotated keys (B, T, KVH, Dh) of every position of ``toks``,
    from the embeddings alone (what a one-layer cache holds)."""
    bp = tparams["blocks"][0]
    x = rmsnorm(bp["ln1"], embed_tokens(tparams["embed"], torch.from_numpy(toks).long(),
                                        torch.float32))
    _, k, _ = _proj_qkv(bp["attn"], x, x, tmodel.cfg)
    pos = torch.arange(toks.shape[1])[None, :]
    return apply_rope(k, pos, tmodel.cfg.rope_theta)


def _sliding_window_logits(tmodel, tparams, toks):
    """The last position's logits of a one-layer llama4 whose attention
    sees the last SPAN keys (itself included), with the MoE of a one-token
    decode step: what decode after the prompt ``toks[:, :-1]`` must give."""
    cfg, bp = tmodel.cfg, tparams["blocks"][0]
    x = embed_tokens(tparams["embed"], torch.from_numpy(toks).long(), torch.float32)
    h = rmsnorm(bp["ln1"], x)
    q, k, v = _proj_qkv(bp["attn"], h, h, cfg)
    pos = torch.arange(toks.shape[1])[None, :]
    q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    kw, vw = (t[:, -SPAN:].repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bhd,bkhd->bhk", q[:, -1], kw) * cfg.head_dim ** -0.5
    out = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1), vw)
    y = x[:, -1:] + out.reshape(x.shape[0], 1, cfg.q_dim) @ bp["attn"]["wo"]
    ffn, _ = tmoe.apply_moe(bp["moe"], cfg, rmsnorm(bp["ln2"], y), group_size=1)
    return head_logits(cfg, tparams, rmsnorm(tparams["final_ln"], y + ffn)[:, -1])


def test_chunked_local_tail():
    model, params, tmodel, tparams = _ring_pair()
    toks = tokens(11, (1, 41))
    prompt, nxt = toks[:, :40], toks[:, 40:]
    k_all = _layer0_k(tmodel, tparams, toks)
    # the reference: after the 40-token prompt slot j holds position 8 + j, so
    # decode (pos 40, slot 8) overwrites position 16 and keeps position 8
    lj, cj = model.prefill(params, {"tokens": jnp.asarray(prompt)}, 64)
    jk = np.array(cj["layers"]["k"][0])
    assert jk.shape[1] == SPAN
    assert rel(torch.from_numpy(jk), k_all[:, 8:40].numpy()) < LOGIT_TOL
    lj2, cj2 = model.decode_step(params, cj, jnp.asarray(nxt))
    jk2 = np.array(cj2["layers"]["k"][0])
    assert np.array_equal(jk2[:, [j for j in range(SPAN) if j != 8]],
                          jk[:, [j for j in range(SPAN) if j != 8]])
    assert rel(torch.from_numpy(jk2[:, 8]), k_all[:, 40].numpy()) < LOGIT_TOL
    assert rel(torch.from_numpy(jk2[:, 0]), k_all[:, 8].numpy()) < LOGIT_TOL   # still there
    # the port: position p at slot p % span, so decode drops position 8
    lt, ct = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, 64)
    assert rel(lt, lj) < LOGIT_TOL                               # prefill output unchanged
    pk = ct["layers"]["k"][0]
    for p in range(8, 40):
        assert rel(pk[:, p % SPAN], k_all[:, p].numpy()) < LOGIT_TOL, p
    lt2, ct2 = tmodel.decode_step(tparams, ct, torch.from_numpy(nxt).long())
    assert rel(ct2["layers"]["k"][0][:, 40 % SPAN], k_all[:, 40].numpy()) < LOGIT_TOL
    want = _sliding_window_logits(tmodel, tparams, toks)
    assert rel(lt2, want.numpy()) < LOGIT_TOL
    assert rel(torch.from_numpy(np.array(lj2)), want.numpy()) > 1e-3   # the reference's fault


@pytest.mark.parametrize("t,max_len", [(20, 64), (32, 64), (64, 80)])
def test_chunked_local_equals_reference_where_slots_agree(t, max_len):
    """Where ``t <= span`` or ``t % span == 0`` the two placements agree:
    prefill and three decode steps equal the reference's, caches included,
    and the decode logits equal the sliding window's."""
    model, params, tmodel, tparams = _ring_pair()
    toks = tokens(12, (1, t + 3))
    lj, cj = model.prefill(params, {"tokens": jnp.asarray(toks[:, :t])}, max_len)
    lt, ct = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :t])}, max_len)
    assert rel(lt, lj) < LOGIT_TOL
    for i in range(t, t + 3):
        nxt = toks[:, i:i + 1]
        lj, cj = model.decode_step(params, cj, jnp.asarray(nxt))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(nxt).long())
        assert rel(lt, lj) < LOGIT_TOL
        assert rel(ct["layers"]["k"], cj["layers"]["k"]) < LOGIT_TOL
        assert rel(lt, _sliding_window_logits(tmodel, tparams, toks[:, :i + 1]).numpy()) \
            < LOGIT_TOL
