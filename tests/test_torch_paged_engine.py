"""The port's paged ServeEngine (block pool + prefix cache) against the JAX one.

Mirrors tests/test_paged.py and tests/test_prefix_cache.py: reduced granite,
2 layers, fp32, the same weights through ``params_from_jax``, prompts from a
seeded numpy generator and the same ``EngineConfig`` on both sides.  Greedy
``out_tokens`` must be identical, and so must every ``EngineSnapshot`` field
that is not a wall-clock time (prefix lookups and hits, skipped prefills,
COW splits, block peaks, evictions, preemptions, resumes, rejections,
prefill dispatches, ...).  Seeded stochastic sampling draws other bits than
the reference's, so stochastic runs are compared within the port.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
from repro.serving.backends import PagedBackend as JaxPagedBackend
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.serving.backends import DenseBackend, PagedBackend
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.sampling import SamplingParams

# EngineSnapshot fields read off a clock (``phases``: the port's host
# seconds of the engine's phases, which the reference lacks); every other
# field must match
WALL = {"wall_s", "tokens_per_s", "ttft", "tpot", "queue_wait", "phases"}


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


def _counters(snap) -> dict:
    return {k: v for k, v in dataclasses.asdict(snap).items() if k not in WALL}


def _run(engine_cls, model, params, prompts, config=None, max_batch=4, max_new=6,
         max_len=48, sampling=None):
    eng = engine_cls(model, params, max_batch=max_batch, max_len=max_len, config=config)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, sampling=sampling[i] if sampling else None)
    done = eng.run_until_drained()
    return {r.rid: r.out_tokens for r in done}, eng


def _both(lms, prompts, config=None, **kw):
    """Serve ``prompts`` on the port and on the JAX engine with the same
    config; assert identical tokens and counters; return the port's run."""
    model, params, tmodel, tparams = lms
    jcfg = JaxEngineConfig(**dataclasses.asdict(config)) if config else None
    port, eng = _run(ServeEngine, tmodel, tparams, prompts, config, **kw)
    ref, jeng = _run(JaxEngine, model, params, prompts, jcfg, **kw)
    assert port == ref
    assert _counters(eng.metrics_snapshot()) == _counters(jeng.metrics_snapshot())
    assert [r.rid for r in eng.scheduler.rejected] == [r.rid for r in jeng.scheduler.rejected]
    return port, eng


def _prompts(lms, seed, sizes, prefix=0):
    rng = np.random.default_rng(seed)
    v = lms[2].cfg.vocab_size
    head = rng.integers(0, v, size=prefix)
    return [np.concatenate([head, rng.integers(0, v, size=int(n))]) for n in sizes]


def test_paged_engine_matches_dense_and_jax(lms):
    prompts = _prompts(lms, 1, (5, 9, 14, 7, 21, 3))
    dense, deng = _run(ServeEngine, lms[2], lms[3], prompts)
    paged, eng = _both(lms, prompts, EngineConfig(kv_blocks=40, kv_block_size=4))
    assert isinstance(deng.backend, DenseBackend) and isinstance(eng.backend, PagedBackend)
    assert dense == paged
    snap = eng.metrics_snapshot()
    assert snap.preemptions == 0
    assert snap.kv_blocks_total == 40 and snap.kv_blocks_peak > 0
    assert 0.0 < snap.kv_block_utilization <= 1.0


def test_preempt_then_resume_token_identical_greedy(lms):
    """A pool too small for every admitted lane to grow preempts (LIFO), and
    the resumed greedy requests give the uninterrupted tokens."""
    prompts = _prompts(lms, 2, (5, 9, 14, 7, 21, 3))
    dense, _ = _run(ServeEngine, lms[2], lms[3], prompts)
    tight, eng = _both(lms, prompts, EngineConfig(kv_blocks=9, kv_block_size=4))
    snap = eng.metrics_snapshot()
    assert dense == tight
    assert snap.preemptions > 0 and snap.resumes > 0 and snap.completed == len(prompts)


def test_preempt_then_resume_token_identical_stochastic(lms):
    """Preemption freezes the lane's sampling key, so a seeded stochastic
    request also resumes on the stream it left (within the port)."""
    prompts = _prompts(lms, 3, (8, 13, 6, 17))
    sp = [SamplingParams(temperature=8.0, top_k=64, seed=100 + i) for i in range(4)]
    ample, _ = _run(ServeEngine, lms[2], lms[3], prompts,
                    EngineConfig(kv_blocks=64, kv_block_size=4), sampling=sp)
    tight, eng = _run(ServeEngine, lms[2], lms[3], prompts,
                      EngineConfig(kv_blocks=8, kv_block_size=4), sampling=sp)
    assert eng.metrics_snapshot().preemptions > 0
    assert ample == tight


def test_admission_with_zero_free_blocks_waits(lms):
    _, _, tmodel, tparams = lms
    rng = np.random.default_rng(4)
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=48,
                      config=EngineConfig(kv_blocks=2, kv_block_size=8))
    first = eng.submit(rng.integers(0, tmodel.cfg.vocab_size, size=14), max_new=2)
    second = eng.submit(rng.integers(0, tmodel.cfg.vocab_size, size=8), max_new=2)
    eng._admit()
    assert eng.active() == 1                # only the first fits
    assert eng.scheduler.depth == 1 and eng.backend.blocks.free == 0
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == [first, second]
    assert eng.backend.blocks.free == 2     # everything released
    prompts = _prompts(lms, 4, (14, 8))
    _both(lms, prompts, EngineConfig(kv_blocks=2, kv_block_size=8), max_batch=2, max_new=2)


@pytest.mark.parametrize("watermark", [0.0, 0.3])
def test_request_larger_than_pool_is_rejected_not_livelocked(lms, watermark):
    """Feasibility is judged on the final footprint (and on the
    watermark-reduced pool): requests that can never fit are rejected up
    front, with zero wasted decode steps, and later traffic is served."""
    if watermark:
        prompts, cfg = _prompts(lms, 9, (14, 6)), EngineConfig(kv_blocks=4, kv_block_size=4,
                                                               watermark_frac=watermark)
        want = [0]
    else:
        prompts, cfg = _prompts(lms, 5, (20, 7, 6)), EngineConfig(kv_blocks=2,
                                                                 kv_block_size=4)
        want = [0, 1]
    model, params, tmodel, tparams = lms
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=48, config=cfg)
    rids = [eng.submit(p, max_new=6 if (not watermark and i == 1) else 2)
            for i, p in enumerate(prompts)]
    done = eng.run_until_drained(max_steps=200)
    assert [r.rid for r in done] == [rids[-1]]
    assert sorted(r.rid for r in eng.scheduler.rejected) == want
    snap = eng.metrics_snapshot()
    assert snap.rejected == len(want) and snap.preemptions == 0
    jeng = JaxEngine(model, params, max_batch=2, max_len=48,
                     config=JaxEngineConfig(**dataclasses.asdict(cfg)))
    for i, p in enumerate(prompts):
        jeng.submit(p, max_new=6 if (not watermark and i == 1) else 2)
    jdone = jeng.run_until_drained(max_steps=200)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert _counters(snap) == _counters(jeng.metrics_snapshot())


def test_running_lane_growth_outranks_admission(lms):
    _, _, tmodel, tparams = lms
    rng = np.random.default_rng(10)
    eng = ServeEngine(tmodel, tparams, max_batch=2, max_len=48,
                      config=EngineConfig(kv_blocks=3, kv_block_size=4))
    a = eng.submit(rng.integers(0, tmodel.cfg.vocab_size, size=7), max_new=6)
    eng.step()                                  # A active on 2 blocks
    b = eng.submit(rng.integers(0, tmodel.cfg.vocab_size, size=3), max_new=2)
    eng.step()              # A grows into the last block FIRST; B must wait
    assert eng.scheduler.depth == 1
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == [a, b]
    assert eng.metrics_snapshot().preemptions == 0


def test_shared_prefix_admits_more_lanes_token_identically(lms):
    """Requests sharing a prompt prefix decode the tokens of an uncached
    engine and charge the pool once for the prefix; other lanes stay live
    while later ones share it."""
    prompts = _prompts(lms, 10, (5, 9, 3, 7), prefix=24)
    plain, _ = _both(lms, prompts, EngineConfig(kv_blocks=60, kv_block_size=4),
                     max_new=5, max_len=64)
    cached, eng = _both(lms, prompts, EngineConfig(kv_blocks=60, kv_block_size=4,
                                                   prefix_cache=True), max_new=5, max_len=64)
    snap = eng.metrics_snapshot()
    assert plain == cached
    assert snap.prefix_hit_rate > 0.4
    assert snap.kv_shared_blocks_peak >= 6      # 24-token prefix, bs=4
    assert snap.kv_blocks_peak < 4 * 10


def test_full_hit_skips_prefill_and_cow_splits_on_write(lms):
    """A fully cached prompt skips its prefill; two concurrent full-hit
    lanes first write into the same shared tail block, so one COW-splits.
    Tokens equal an uncached run, counters the JAX engine's."""
    model, params, tmodel, tparams = lms
    p = _prompts(lms, 11, (10,))[0]
    ref, _ = _run(ServeEngine, tmodel, tparams, [p], max_batch=2, max_new=5, max_len=64)
    runs = []
    for cls, cfg_cls, m, prm in ((ServeEngine, EngineConfig, tmodel, tparams),
                                 (JaxEngine, JaxEngineConfig, model, params)):
        eng = cls(m, prm, max_batch=2, max_len=64,
                  config=cfg_cls(kv_blocks=30, kv_block_size=4, prefix_cache=True))
        w = eng.submit(p, max_new=5)
        warm = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        a, b = eng.submit(p, max_new=5), eng.submit(p, max_new=5)
        done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        assert done[a] == done[b] == warm[w] == ref[0]
        runs.append(_counters(eng.metrics_snapshot()))
    assert runs[0] == runs[1]
    assert runs[0]["prefill_skipped"] == 2 and runs[0]["cow_splits"] >= 1


def test_preempt_resume_of_lane_holding_shared_blocks(lms):
    prompts = _prompts(lms, 12, (6, 9, 4, 8), prefix=12)
    ample, _ = _run(ServeEngine, lms[2], lms[3], prompts, max_new=7, max_len=64)
    tight, eng = _both(lms, prompts, EngineConfig(kv_blocks=12, kv_block_size=4,
                                                  prefix_cache=True), max_new=7, max_len=64)
    snap = eng.metrics_snapshot()
    assert snap.preemptions > 0 and snap.resumes > 0
    assert ample == tight
    assert eng.backend.blocks.in_use == 0       # every reference returned


def test_chat_traffic_full_hits_cow_preemption_and_rejection(lms):
    """One run with everything at once: a shared system prompt, a tight
    pool, repeats of finished prompts (full hits) and a request too large to
    ever fit."""
    model, params, tmodel, tparams = lms
    prompts = _prompts(lms, 13, (3, 9, 6, 11, 5), prefix=16)
    cfg = EngineConfig(kv_blocks=14, kv_block_size=4, prefix_cache=True)
    runs = []
    for cls, cfg_cls, m, prm in ((ServeEngine, EngineConfig, tmodel, tparams),
                                 (JaxEngine, JaxEngineConfig, model, params)):
        eng = cls(m, prm, max_batch=4, max_len=48, config=cfg_cls(**dataclasses.asdict(cfg)))
        for p in prompts:
            eng.submit(p, max_new=8)
        eng.submit(np.concatenate([prompts[0], prompts[1]]), max_new=20)   # never fits
        for _ in range(4):
            eng.step()
        for p in (prompts[0], prompts[0], prompts[1]):   # full hits, two sharing a tail
            eng.submit(p, max_new=8)
        done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        runs.append((done, _counters(eng.metrics_snapshot()), eng.backend.blocks.in_use))
    assert runs[0] == runs[1]
    c = runs[0][1]
    assert c["prefill_skipped"] >= 1 and c["cow_splits"] >= 1
    assert c["preemptions"] >= 1 and c["rejected"] == 1 and runs[0][2] == 0


@pytest.mark.parametrize("n_cached,n_ctx,width", [(0, 7, 16), (8, 11, 16), (4, 4, 8),
                                                  (12, 13, 32)])
def test_flat_idx_sends_shared_prefix_and_pad_to_the_sink(n_cached, n_ctx, width):
    blocks = [5, 2, 9, 3]
    stub = types.SimpleNamespace(blocks=types.SimpleNamespace(block_size=4))
    got = PagedBackend._flat_idx(stub, blocks, n_cached, n_ctx, width)
    assert np.array_equal(got, JaxPagedBackend._flat_idx(stub, blocks, n_cached, n_ctx, width))
    i = np.arange(width)
    mine = (i >= n_cached) & (i < n_ctx)
    assert (got[~mine] < 4).all()               # sink rows: block 0
    assert (got[mine] // 4 == np.array(blocks)[i[mine] // 4]).all()


def test_forced_backend_validation(lms):
    _, _, tmodel, tparams = lms
    with pytest.raises(ValueError, match="kv_blocks"):
        ServeEngine(tmodel, tparams, max_batch=2, max_len=32,
                    config=EngineConfig(backend="paged"))
    with pytest.raises(ValueError, match="recurrent"):
        ServeEngine(tmodel, tparams, max_batch=2, max_len=32,
                    config=EngineConfig(backend="recurrent"))
    with pytest.raises(ValueError, match="unknown backend"):
        ServeEngine(tmodel, tparams, max_batch=2, max_len=32,
                    config=EngineConfig(backend="ring"))
    chunked = tbuild_model(dataclasses.replace(tmodel.cfg, attention="chunked_local",
                                               chunk_size=16), tmodel.rcfg, device="cpu")
    assert not chunked.decode_state.poolable
    with pytest.raises(ValueError, match="pageable"):
        ServeEngine(chunked, chunked.init(0), max_batch=1, max_len=32,
                    config=EngineConfig(backend="paged", kv_blocks=8))
    eng = ServeEngine(chunked, tparams, max_batch=1, max_len=32,
                      config=EngineConfig(kv_blocks=8))       # auto: dense lanes
    assert isinstance(eng.backend, DenseBackend)
    dense = ServeEngine(tmodel, tparams, max_batch=2, max_len=32,
                        config=EngineConfig(backend="dense", kv_blocks=8))
    assert isinstance(dense.backend, DenseBackend)
