"""The port's ServeEngine against the JAX ServeEngine (mirrors test_serving.py).

Reduced granite, 2 layers, fp32, the same weights through ``params_from_jax``,
the same prompts from a seeded numpy generator: greedy ``out_tokens`` must be
identical.  The port's CPU tensors take the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.sampling import _filter_one as jax_filter_one
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.engine_api import REQUIRED_ATTRS, DecodeEngine
from repro_torch.serving.sampling import SamplingParams, _filter_one

MAX_LEN = 48


@pytest.fixture(scope="module")
def lms():
    cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=2)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False))
    params = model.init(jax.random.key(0))
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                               n_layers=2)
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                   compute_dtype="float32", remat=False),
                         device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return model, params, tmodel, tparams


def _run(engine_cls, model, params, prompts, max_new=4, sampling=None, **kw):
    eng = engine_cls(model, params, **{"max_batch": 2, "max_len": MAX_LEN, **kw})
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, sampling=sampling[i] if sampling else None)
    return {r.rid: r.out_tokens for r in eng.run_until_drained()}, eng


def _naive_greedy(tmodel, tparams, prompt, n):
    v = tmodel.cfg.vocab_size
    logits, cache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt[None]).long()},
                                   MAX_LEN)
    toks = [int(torch.argmax(logits[0, :v]))]
    for _ in range(n - 1):
        logits, cache = tmodel.decode_step(tparams, cache, torch.tensor([[toks[-1]]]))
        toks.append(int(torch.argmax(logits[0, :v])))
    return toks


def test_continuous_batching_matches_naive_and_jax(lms):
    model, params, tmodel, tparams = lms
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=5 + i) for i in range(4)]
    port, _ = _run(ServeEngine, tmodel, tparams, prompts)
    ref, _ = _run(JaxEngine, model, params, prompts)
    assert len(port) == 4
    assert port == ref
    for rid, p in enumerate(prompts):
        assert port[rid] == _naive_greedy(tmodel, tparams, p, 4)


def test_bucketed_prefill_matches_per_request(lms):
    """Batched padded prefill is token-for-token the per-request path, in
    fewer dispatches, and both match the JAX engine."""
    model, params, tmodel, tparams = lms
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=4 + (3 * i) % 11)
               for i in range(16)]
    bucketed, eng_b = _run(ServeEngine, tmodel, tparams, prompts, max_batch=16)
    per_req = dataclasses.replace(tmodel, decode_state=dataclasses.replace(
        tmodel.decode_state, batched_prefill=None))
    fallback, eng_f = _run(ServeEngine, per_req, tparams, prompts, max_batch=16)
    ref, _ = _run(JaxEngine, model, params, prompts, max_batch=16)
    assert bucketed == fallback == ref
    snap_b, snap_f = eng_b.metrics_snapshot(), eng_f.metrics_snapshot()
    assert snap_f.prefill_dispatches == 16
    assert snap_b.prefill_dispatches < 16
    assert snap_b.prefill_requests == 16 and snap_b.prefill_batch_mean > 1.0


def test_engine_max_new_one_and_eos_on_first_token(lms):
    _, _, tmodel, tparams = lms
    prompt = np.random.default_rng(6).integers(0, tmodel.cfg.vocab_size, size=7)
    done, _ = _run(ServeEngine, tmodel, tparams, [prompt], max_new=1)
    assert len(done[0]) == 1
    first = done[0][0]
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=MAX_LEN, eos_id=first)
    eng.submit(prompt, max_new=10)
    assert eng.run_until_drained()[0].out_tokens == [first]
    assert eng.steps == 0                         # never reached decode
    # an instant finish refills its lane in the same admission round
    eng = ServeEngine(tmodel, tparams, max_batch=1, max_len=MAX_LEN)
    eng.submit(prompt, max_new=1)
    eng.submit(prompt, max_new=3)
    eng._admit()
    assert len(eng.finished) == 1 and eng.active() == 1


def test_engine_rejects_buckets_beyond_max_len(lms):
    _, _, tmodel, tparams = lms
    with pytest.raises(ValueError):
        ServeEngine(tmodel, tparams, max_batch=2, max_len=32, prefill_buckets=(16, 64))


@pytest.mark.parametrize("temperature", [0.0, 4.0])
def test_preempt_resume_is_token_identical(lms, temperature):
    """Preempting a lane mid-decode and resuming it by re-prefill (with its
    frozen sampling key) reproduces the uninterrupted tokens exactly."""
    _, _, tmodel, tparams = lms
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=n) for n in (6, 9, 4)]
    sps = [SamplingParams(temperature=temperature, top_k=32, seed=10 + i) for i in range(3)]
    ref, _ = _run(ServeEngine, tmodel, tparams, prompts, max_new=8, sampling=sps)

    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=MAX_LEN)
    for p, sp in zip(prompts, sps):
        eng.submit(p, max_new=8, sampling=sp)
    for _ in range(3):
        eng.step()
    victim = eng.preempt(0)
    assert victim.preemptions == 1 and 0 < len(victim.out_tokens) < 8
    moved = eng.preempt(1, requeue=False)          # migration hook: returned, not queued
    assert eng.active() == 0
    assert eng.inject(moved)
    done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
    assert done == ref


def test_fleet_hooks_and_protocol(lms):
    _, _, tmodel, tparams = lms
    rng = np.random.default_rng(4)
    eng = ServeEngine(tmodel, tparams, max_batch=1, max_len=MAX_LEN,
                      config=EngineConfig(pad_id=1))
    assert isinstance(eng, DecodeEngine)
    assert all(hasattr(eng, a) for a in REQUIRED_ATTRS)
    for n in (5, 6, 7):
        eng.submit(rng.integers(0, tmodel.cfg.vocab_size, size=n), max_new=3)
    eng.step()
    queued = eng.pull_queued()
    assert len(queued) == 2 and eng.scheduler.depth == 0
    lost = eng.forget_lane(0)
    assert lost.preemptions == 1 and eng.active() == 0
    assert eng.feasible(lost) and eng.inject(lost, force=True)
    for r in queued:
        eng.inject(r)
    done = eng.run_until_drained()
    assert sorted(len(r.out_tokens) for r in done) == [3, 3, 3]


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.7, 20, 1.0), (1.3, 0, 0.9),
                                   (0.5, 50, 0.6), (2.0, 1, 1.0)])
def test_filter_one_matches_jax(t, k, p):
    logits = (3.0 * np.random.default_rng(5).standard_normal(512)).astype(np.float32)
    ref = np.asarray(jax_filter_one(jnp.asarray(logits), jnp.float32(t), jnp.int32(k),
                                    jnp.float32(p)))
    got = _filter_one(torch.from_numpy(logits), t, k, p).numpy()
    kept = ref > -1e29
    assert np.array_equal(got > -1e29, kept) and kept.any()
    assert np.allclose(got[kept], ref[kept], rtol=0, atol=1e-6)


def test_seeded_sampling_reproducible_and_placement_independent(lms):
    _, _, tmodel, tparams = lms
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=6) for _ in range(3)]
    sps = [SamplingParams(temperature=8.0, top_k=64, seed=123 + i) for i in range(3)]
    a, _ = _run(ServeEngine, tmodel, tparams, prompts, max_new=5, sampling=sps)
    b, _ = _run(ServeEngine, tmodel, tparams, prompts, max_new=5, sampling=sps)
    assert a == b                                  # fixed seeds -> identical
    # other lane counts and submission order place each request elsewhere
    wide, _ = _run(ServeEngine, tmodel, tparams, prompts, max_new=5, sampling=sps,
                   max_batch=3)
    rev, _ = _run(ServeEngine, tmodel, tparams, prompts[::-1], max_new=5,
                  sampling=sps[::-1], max_batch=1)
    assert wide == a
    assert {rid: rev[2 - rid] for rid in range(3)} == a
    greedy, _ = _run(ServeEngine, tmodel, tparams, prompts, max_new=5)
    assert a != greedy                             # and actually stochastic
