"""Recurrent serving in the port (rwkv6 and zamba2) against the JAX package.

Reduced configs, 2 layers, fp32, the same weights through
``params_from_jax``, prompts from seeded numpy generators.  Tolerance
1e-4 x max(1, |ref|) on logits and on every cache leaf: the port prefills
through the chunked scans (``ops.rwkv6_scan`` with the final state formed
outside it, ``ops.mamba2_ssd``), the reference through its token
recurrences, and the two sum in different orders.  Greedy tokens and
every ``EngineSnapshot`` field that is not a wall-clock time must be
identical between the two engines, over the recurrent backend and over
dense lanes, with and without a preemption.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced_config
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.api import build_model
from repro.serving.backends import RecurrentBackend as JaxRecurrentBackend
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax, tensor_from_numpy
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.serving.backends import (DenseBackend, PagedBackend, RecurrentBackend,
                                          lane_leaves)
from repro_torch.serving.engine import EngineConfig, ServeEngine

TOL = 1e-4
MAX_LEN = 32
ARCHS = ("rwkv6-1.6b", "zamba2-7b")
# EngineSnapshot fields read off a clock (``phases``: the port's host
# seconds of the engine's phases, which the reference lacks); every other
# field must match
WALL = {"wall_s", "tokens_per_s", "ttft", "tpot", "queue_wait", "phases"}


def _models(arch, n_layers=2):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                               n_layers=n_layers)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                   compute_dtype="float32", remat=False),
                          device="cpu")
    return model, tmodel


@pytest.fixture(scope="module", params=ARCHS)
def lms(request):
    """(jax model, jax params, port model, port params) of one family."""
    model, tmodel = _models(request.param)
    params = model.init(jax.random.key(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return model, params, tmodel, tparams


def _err(port: torch.Tensor, ref) -> float:
    """max |port - ref| / max(1, max|ref|)."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _leaf_errs(tcache: dict, jcache) -> dict:
    """{path: error} over every leaf of the JAX cache, shapes held equal."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jcache))[0]:
        keys = [p.key for p in path]
        t = tcache
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == a.shape, keys
        out["/".join(keys)] = _err(t, a)
    return out


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("t", [1, 2, 11, 37])
def test_prefill_logits_and_every_state_leaf_match_jax(lms, t):
    """Prefill from the empty state: logits and every leaf of the cache
    tree, the reference's dtypes included (fp32 ``S``/``ssm``, int32 ``pos``)."""
    model, params, tmodel, tparams = lms
    toks = _tokens(t, (1, t))
    jl, jc = model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks).long()}, MAX_LEN)
    assert _err(tl, jl) < TOL
    errs = _leaf_errs(tc, jc)
    assert max(errs.values()) < TOL, errs
    jdt = {"/".join(p.key for p in path): str(np.asarray(a).dtype)
           for path, a in jax.tree_util.tree_flatten_with_path(jc)[0]}
    tdt = {k: str(tc[k.split("/")[0]][k.split("/")[1]].dtype if "/" in k else tc[k].dtype)
           .replace("torch.", "") for k in errs}
    assert tdt == jdt


def test_decode_step_from_the_jax_cache_matches_jax(lms):
    """Two lanes prefilled by the JAX model; one decode step of each package
    from that very cache (``cache_from_jax``): logits and every new leaf,
    zamba2's shared-block slots included (written through a view)."""
    model, params, tmodel, tparams = lms
    toks = _tokens(7, (2, 9))
    _, jc = model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    nxt = _tokens(8, (2, 1))
    jl, jc2 = model.decode_step(params, jc, jnp.asarray(nxt))
    with torch.no_grad():
        tl, tc2 = tmodel.decode_step(tparams, tc, torch.as_tensor(nxt).long())
    assert _err(tl, jl) < TOL
    errs = _leaf_errs(tc2, jc2)
    assert max(errs.values()) < TOL, errs
    if "ak" in tc2:        # this token's K landed in the slot, in place
        assert float(tc2["ak"][:, :, 9].abs().max()) > 0
        assert tc2["ak"] is tc["ak"]


def test_state_units_match_the_jax_backend(lms):
    model, params, tmodel, tparams = lms
    port = RecurrentBackend(tmodel, 3, MAX_LEN)
    ref = JaxRecurrentBackend(model, 3, MAX_LEN)
    assert port.state_units == ref.state_units
    assert port.token_footprint(5, 4) == port.token_footprint(30, 1) == port.state_units
    assert port.snapshot_free


def _serve(engine_cls, model, params, prompts, config=None, preempt_after=None, **kw):
    eng = engine_cls(model, params, max_batch=kw.get("max_batch", 3), max_len=MAX_LEN,
                     config=config)
    for p in prompts:
        eng.submit(p, max_new=kw.get("max_new", 4))
    if preempt_after is not None:
        for _ in range(preempt_after):
            eng.step()
        eng.preempt(0)
    done = eng.run_until_drained()
    return {r.rid: r.out_tokens for r in done}, eng


def _counters(eng) -> dict:
    return {k: v for k, v in dataclasses.asdict(eng.metrics_snapshot()).items()
            if k not in WALL}


@pytest.mark.parametrize("backend", ["recurrent", "dense"])
def test_engine_tokens_and_counters_match_jax(lms, backend):
    """The prompts and engine of tests/test_prefix_cache.py's backend parity
    (5, 11 and 8 tokens, max_batch 3, max_new 4): tokens and counters equal
    the JAX engine's, and the two layouts give the same tokens."""
    model, params, tmodel, tparams = lms
    prompts = [_tokens(14 + i, (n,)) for i, n in enumerate((5, 11, 8))]
    port, eng = _serve(ServeEngine, tmodel, tparams, prompts, EngineConfig(backend=backend))
    ref, jeng = _serve(JaxEngine, model, params, prompts, JaxEngineConfig(backend=backend))
    assert eng.backend.name == jeng.backend.name == backend
    assert port == ref
    assert _counters(eng) == _counters(jeng)
    assert _counters(eng)["prefill_dispatches"] == len(prompts)
    other, _ = _serve(ServeEngine, tmodel, tparams, prompts,
                      EngineConfig(backend="dense" if backend == "recurrent" else "recurrent"))
    assert other == port


def test_recurrent_preempt_restores_without_recompute(lms):
    """Mirror of tests/test_prefix_cache.py's test: one lane preempted after
    2 steps resumes from its snapshot, token-identical, with the one prefill
    dispatch of its admission; the JAX engine does the same."""
    model, params, tmodel, tparams = lms
    prompt = [_tokens(3, (7,))]
    want, _ = _serve(ServeEngine, tmodel, tparams, prompt, max_batch=1, max_new=6)
    got, eng = _serve(ServeEngine, tmodel, tparams, prompt, preempt_after=2, max_batch=1,
                      max_new=6)
    ref, jeng = _serve(JaxEngine, model, params, prompt, preempt_after=2, max_batch=1,
                       max_new=6)
    snap = eng.metrics_snapshot()
    assert got == want == ref
    assert snap.preemptions == 1 and snap.resumes == 1
    assert snap.prefill_dispatches == 1          # restore, not recompute
    assert _counters(eng) == _counters(jeng)


def test_preempted_dense_lane_recomputes(lms):
    """Over dense lanes the same preemption re-prefills (two dispatches),
    with the same tokens as the JAX engine."""
    model, params, tmodel, tparams = lms
    prompt = [_tokens(3, (7,))]
    kw = dict(preempt_after=2, max_batch=1, max_new=6)
    got, eng = _serve(ServeEngine, tmodel, tparams, prompt, EngineConfig(backend="dense"), **kw)
    ref, jeng = _serve(JaxEngine, model, params, prompt, JaxEngineConfig(backend="dense"), **kw)
    assert got == ref
    assert eng.metrics_snapshot().prefill_dispatches == 2
    assert _counters(eng) == _counters(jeng)


def test_snapshot_is_a_host_copy_and_restores_bit_equal(lms):
    """A snapshot is a copy on the host that later in-place steps leave as
    it was; restoring it into another lane makes that lane bit-equal to it."""
    _, _, tmodel, tparams = lms
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=MAX_LEN)
    eng.submit(_tokens(4, (6,)), max_new=8)
    eng.step()
    snap = eng.backend.snapshot(0)
    before = {k: v.clone() for k, v in snap.items()}
    eng.step()
    live = lane_leaves(eng.backend.cache, 0)
    assert all(torch.equal(snap[k], before[k]) for k in snap)
    assert not all(torch.equal(live[k], snap[k]) for k in snap)      # the lane moved on
    assert eng.backend.restore(1, snap)
    lane1 = lane_leaves(eng.backend.cache, 1)
    assert all(torch.equal(lane1[k], snap[k]) and lane1[k].dtype == snap[k].dtype
               for k in snap)
    assert eng.lane_cost(0) == (0, eng.backend.state_units)


def test_fleet_hooks_keep_and_clear_the_saved_state(lms):
    _, _, tmodel, tparams = lms
    eng = ServeEngine(tmodel, tparams, max_batch=1, max_len=MAX_LEN)
    eng.submit(_tokens(5, (6,)), max_new=8)
    eng.step()
    req = eng.preempt(0, requeue=False)
    assert req.saved_state is not None
    assert eng.inject(req, force=True)
    eng.step()                                    # restored, no prefill
    assert eng.slots[0] is req and req.saved_state is None
    assert eng.metrics_snapshot().prefill_dispatches == 1
    gone = eng.forget_lane(0)
    assert gone.saved_state is None and eng.active() == 0


def test_backend_auto_selection():
    """Recurrent families get recurrent lanes by default, with kv_blocks too
    (nothing of theirs is pageable), dense lanes when asked; attention
    families get dense lanes, or the pool with kv_blocks, and refuse the
    recurrent layout."""
    _, rwkv = _models("rwkv6-1.6b", 1)
    _, granite = _models("granite-8b", 1)
    rp, gp = rwkv.init(0), granite.init(0)
    pick = lambda m, p, **kw: type(ServeEngine(m, p, max_batch=2, max_len=MAX_LEN,
                                               config=EngineConfig(**kw)).backend)
    assert pick(rwkv, rp) is RecurrentBackend
    assert pick(rwkv, rp, kv_blocks=16, kv_block_size=4) is RecurrentBackend
    assert pick(rwkv, rp, backend="dense") is DenseBackend
    assert rwkv.decode_state.kind == "recurrent" and rwkv.decode_state.batched_prefill is None
    assert pick(granite, gp) is DenseBackend
    assert pick(granite, gp, kv_blocks=16, kv_block_size=4) is PagedBackend
    with pytest.raises(ValueError, match="recurrent"):
        pick(granite, gp, backend="recurrent")
    with pytest.raises(ValueError, match="pageable"):
        pick(rwkv, rp, backend="paged", kv_blocks=16)


@pytest.mark.parametrize("log_decay", [-5.0, -0.05])
def test_rwkv_prefill_state_under_strong_decay_matches_the_recurrence(log_decay):
    """The final state formed outside the scan, from suffix sums of the
    log-decay, against the token recurrence (port and JAX) at a log-decay of
    about ``log_decay`` a token over 300 tokens: finite, within tolerance."""
    rng = np.random.default_rng(11)
    b, t, h, dk = 2, 300, 3, 16
    r, k, v = (rng.standard_normal((b, t, h, dk)).astype(np.float32) for _ in range(3))
    lw = (log_decay * np.exp(0.2 * rng.standard_normal((b, t, h, dk)))).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, dk))).astype(np.float32)
    w = np.exp(lw)
    got = trwkv.rwkv6_final_state(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.log(torch.from_numpy(w)))
    _, rec = trwkv.rwkv6_scan_plain(*map(torch.from_numpy, (r, k, v, w, u)))
    _, jrec = jrwkv.rwkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u)))
    assert torch.isfinite(got).all()
    assert _err(got, rec.numpy()) < TOL and _err(got, jrec) < TOL


@pytest.mark.parametrize("t", [1, 2, 5])
def test_conv_tail_of_short_prompts_matches_jax(t):
    """The conv tail after a prompt shorter than K-1 keeps the zero pad;
    one more token from that tail gives the reference's output and tail."""
    rng = np.random.default_rng(t)
    xbc = rng.standard_normal((2, t, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    nxt = rng.standard_normal((2, 1, 24)).astype(np.float32)
    jy, jtail = jssm._causal_conv(*map(jnp.asarray, (xbc, w, bias)))
    ty, ttail = tssm._causal_conv(*map(torch.from_numpy, (xbc, w, bias)))
    assert ttail.shape == (2, 3, 24)
    assert _err(ty, jy) < TOL and _err(ttail, jtail) == 0.0
    if t < 3:
        assert float(ttail[:, :3 - t].abs().max()) == 0.0
    jy2, jtail2 = jssm._causal_conv(jnp.asarray(nxt), jnp.asarray(w), jnp.asarray(bias), jtail)
    ty2, ttail2 = tssm._causal_conv(torch.from_numpy(nxt), torch.from_numpy(w),
                                    torch.from_numpy(bias), ttail)
    assert _err(ty2, jy2) < TOL and _err(ttail2, jtail2) == 0.0


def test_bf16_state_leaves_keep_the_reference_dtypes():
    """In bf16 the cache keeps S / ssm in fp32, the rest in bf16, and a
    prefill of the JAX bf16 weights gives logits within bf16 rounding."""
    for arch in ARCHS:
        cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=2)
        tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                                   n_layers=2)
        model = build_model(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                           remat=False))
        tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="bfloat16",
                                                       compute_dtype="bfloat16", remat=False),
                              device="cpu")
        params = model.init(jax.random.key(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        toks = _tokens(1, (1, 12))
        jl, jc = model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
        with torch.no_grad():
            tl, tc = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks).long()}, MAX_LEN)
        ref = tensor_from_numpy(np.asarray(jl)).float()
        assert float((tl.float() - ref).abs().max()) < 0.25
        fp32 = {"S", "ssm"}
        for name, leaf in tc["layers"].items():
            assert leaf.dtype == (torch.float32 if name in fp32 else torch.bfloat16), name
        assert tc["pos"].dtype == torch.int32
