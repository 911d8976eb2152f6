"""The port's stage plane against the JAX package's (mirrors
test_pipeline_decode.py and test_partition.py).

Reduced granite, 4 layers, fp32, the same weights through
``params_from_jax``.  The port's stages run the full model's own layer
loops, so composing them is ``torch.equal`` to the full model; against JAX
the logits hold to 1e-5.  ``PipelineEngine`` gives the JAX engine's greedy
tokens, frame bytes, step reports (wall time aside) and recut bytes
exactly.  The planners are plain Python over floats and return the
reference's plans on the reference's cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.partition as jpart
import repro.hw.specs as jspecs
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import RunConfig, get_config, reduced_config
from repro.models.api import build_model
from repro.models.api import param_bytes as jparam_bytes
from repro.models.api import split_stage_params as jsplit
from repro.models.api import stage_eligible as jeligible
from repro.serving.pipeline_decode import PipelineEngine as JaxPipeline
from repro.serving.pipeline_decode import boundary_frame_bytes as jframe_bytes
from repro.serving.pipeline_decode import plan_decode_split as jplan_decode_split
import repro_torch.configs as tconfigs
import repro_torch.core.partition as tpart
import repro_torch.hw.specs as tspecs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.api import (build_model as tbuild_model, param_bytes,
                                    split_stage_params, stage_eligible, stage_model)
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pipeline_decode import (PipelineEngine, boundary_frame_bytes,
                                                 plan_decode_split)
from repro_torch.serving.sampling import SamplingParams

MAX_LEN = 48
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def lm4():
    cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=4)
    model = build_model(cfg, RunConfig(**F32))
    params = model.init(jax.random.key(0))
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                               n_layers=4)
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(**F32), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return model, params, tmodel, tparams


def _stages(tmodel, tparams, cuts):
    bounds = (0,) + cuts + (tmodel.cfg.n_layers,)
    return (split_stage_params(tmodel, tparams, cuts),
            [stage_model(tmodel, bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)])


def _greedy_traffic(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=6 + i) for i in range(n)]


# ---------------------------------------------------------------------------
# stage execution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cuts", [(2,), (1, 3)], ids=str)
def test_stage_composition_bit_exact_and_matches_jax(lm4, cuts):
    """Stages composed through the boundary hidden are bit-identical to the
    port's full model (prefill logits, then two decode steps), and within
    1e-5 of the JAX full model."""
    model, params, tmodel, tparams = lm4
    toks = np.arange(1, 9, dtype=np.int32)[None]
    want, cache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(toks).long()}, MAX_LEN)
    jwant, jcache = model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    sps, stages = _stages(tmodel, tparams, cuts)
    x, caches = None, []
    for i, (sm, sp) in enumerate(zip(stages, sps)):
        b = {"tokens": torch.as_tensor(toks).long()} if i == 0 else {"hidden": x}
        x, c = sm.prefill(sp, b, MAX_LEN)
        caches.append(c)
    assert torch.equal(want, x)
    np.testing.assert_allclose(x.numpy(), np.asarray(jwant), atol=1e-5, rtol=0)
    for tok in (5, 17):
        want, cache = tmodel.decode_step(tparams, cache, torch.tensor([[tok]]))
        jwant, jcache = model.decode_step(params, jcache, jnp.asarray([[tok]], jnp.int32))
        x = torch.tensor([[tok]])
        for i, (sm, sp) in enumerate(zip(stages, sps)):
            x, caches[i] = sm.decode_step(sp, caches[i], x)
        assert torch.equal(want, x), tok
        np.testing.assert_allclose(x.numpy(), np.asarray(jwant), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_stage_eligibility_matches_reference(arch):
    """The predicate, moe / encdec / frontend branches included, gives the
    reference's verdict on every config the reference registers."""
    jcfg = reduced_config(get_config(arch))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    tcfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    assert stage_eligible(tcfg) == jeligible(jcfg)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_stage_model_refuses_recurrent_families(arch):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    assert not stage_eligible(cfg)
    model = tbuild_model(cfg, tconfigs.RunConfig(**F32), device="cpu")
    with pytest.raises(ValueError, match="cannot be layer-split"):
        stage_model(model, 0, 1)


def test_stage_model_stubs_and_bounds(lm4):
    _, _, tmodel, _ = lm4
    with pytest.raises(ValueError, match="bad stage range"):
        stage_model(tmodel, 2, 2)
    sm = stage_model(tmodel, 0, 2)
    assert sm.device == tmodel.device and sm.cfg.n_layers == 2
    with pytest.raises(RuntimeError, match="full model"):
        sm.init(0)
    with pytest.raises(RuntimeError, match="full model"):
        sm.loss({}, {})
    assert stage_model(tmodel, 0, 2) is sm          # lru-cached: one Model per cut
    with pytest.raises(ValueError, match="strictly increasing"):
        split_stage_params(tmodel, lm4[3], (3, 1))


def test_split_stage_params_memory_accounting(lm4):
    """Each stage holds only its slice plus its ends; tied embeddings are
    charged on both ends, so the stage sum exceeds the full tree by one
    table -- byte for byte the reference's accounting."""
    model, params, tmodel, tparams = lm4
    sps = split_stage_params(tmodel, tparams, (2,))
    total = param_bytes(tparams)
    embed = param_bytes(tparams["embed"])
    assert total == jparam_bytes(params)
    assert all(param_bytes(p) < total for p in sps)
    assert sum(param_bytes(p) for p in sps) == total + embed
    assert "final_ln" not in sps[0] and len(sps[0]["blocks"]) == 2
    assert sps[1]["embed"] is tparams["embed"]
    jsps = jsplit(model, params, (2,))
    assert [param_bytes(p) for p in sps] == [jparam_bytes(p) for p in jsps]


# ---------------------------------------------------------------------------
# PipelineEngine against the JAX engine
# ---------------------------------------------------------------------------
def _drive(engine, prompts, steps_before=None, recut=None, max_new=8):
    """Submit, step (recutting after ``steps_before`` steps), drain; the
    tokens, every step report and the recut's moved bytes."""
    for p in prompts:
        engine.submit(p, max_new=max_new)
    reports, moved = [], None
    for n in range(1000):
        if recut is not None and n == steps_before:
            moved = engine.recut(recut)
        rep = engine.step_paced()
        reports.append(rep)
        if engine.active() == 0 and not engine.scheduler.depth:
            break
    return {r.rid: r.out_tokens for r in engine.finished}, reports, moved


def _wall_free(rep):
    if rep is None:
        return None
    d = dataclasses.asdict(rep)
    walls = d.pop("decode_stage_wall_s")
    assert len(walls) == (len(d["prefill_frame_bytes"]) + 1 if d["decode_step"] else 0)
    assert all(w >= 0.0 for w in walls)
    return d


def _engine_counters(eng):
    return (eng.frames_sent, eng.frame_bytes_total, eng.prefill_frame_bytes_total,
            eng.decode_frame_bytes_total, eng.steps, eng.recuts, eng.cuts)


def test_pipeline_engine_matches_jax_engine(lm4):
    model, params, tmodel, tparams = lm4
    prompts = _greedy_traffic(tmodel.cfg.vocab_size, 5, seed=0)
    got, reps, _ = _drive(PipelineEngine(tmodel, tparams, 3, MAX_LEN, cuts=(2,)), prompts)
    jeng = JaxPipeline(model, params, max_batch=3, max_len=MAX_LEN, cuts=(2,))
    want, jreps, _ = _drive(jeng, prompts)
    assert got == want and len(got) == 5
    assert [_wall_free(r) for r in reps] == [_wall_free(r) for r in jreps]
    eng = PipelineEngine(tmodel, tparams, 3, MAX_LEN, cuts=(2,))
    _drive(eng, prompts)
    assert _engine_counters(eng) == _engine_counters(jeng)
    assert eng.frames_sent > 0 and eng.decode_frame_bytes_total > 0
    assert eng.frame_bytes_total == (eng.decode_frame_bytes_total
                                     + eng.prefill_frame_bytes_total)
    assert eng.stage_param_bytes == jeng.stage_param_bytes
    snap, jsnap = eng.metrics_snapshot(), jeng.metrics_snapshot()
    assert (snap.completed, snap.prefill_dispatches, snap.steps) == \
        (jsnap.completed, jsnap.prefill_dispatches, jsnap.steps)


def test_recut_matches_jax_engine(lm4):
    """Recut (1,) -> (3,) after 3 steps: the same tokens, step reports and
    moved bytes as the JAX engine; the moved bytes are two layers'."""
    model, params, tmodel, tparams = lm4
    prompts = _greedy_traffic(tmodel.cfg.vocab_size, 5, seed=3)
    eng = PipelineEngine(tmodel, tparams, 3, MAX_LEN, cuts=(1,))
    got, reps, moved = _drive(eng, prompts, steps_before=3, recut=(3,))
    jeng = JaxPipeline(model, params, max_batch=3, max_len=MAX_LEN, cuts=(1,))
    want, jreps, jmoved = _drive(jeng, prompts, steps_before=3, recut=(3,))
    assert got == want
    assert moved == jmoved == 2 * (param_bytes(tparams["blocks"]) // 4)
    assert [_wall_free(r) for r in reps] == [_wall_free(r) for r in jreps]
    assert _engine_counters(eng) == _engine_counters(jeng)
    assert eng.recut((3,)) == 0 and eng.recuts == 1
    unsplit = ServeEngine(tmodel, tparams, max_batch=5, max_len=MAX_LEN)
    for p in prompts:
        unsplit.submit(p, max_new=8)
    assert {r.rid: r.out_tokens for r in unsplit.run_until_drained()} == got


def test_pipeline_engine_stochastic_lanes_match_serve_engine(lm4):
    """Seeded stochastic lanes (the port's own draws, not the reference's
    threefry bits) give the port's ServeEngine's tokens, through a recut."""
    _, _, tmodel, tparams = lm4
    prompts = _greedy_traffic(tmodel.cfg.vocab_size, 5, seed=5)
    sps = [SamplingParams(temperature=2.0, top_k=16, seed=700 + i) if i % 2 else None
           for i in range(5)]
    ref = ServeEngine(tmodel, tparams, max_batch=5, max_len=MAX_LEN)
    pipe = PipelineEngine(tmodel, tparams, max_batch=3, max_len=MAX_LEN, cuts=(2,))
    for p, sp in zip(prompts, sps):
        ref.submit(p, max_new=8, sampling=sp)
        pipe.submit(p, max_new=8, sampling=sp)
    want = {r.rid: r.out_tokens for r in ref.run_until_drained()}
    for _ in range(3):
        pipe.step()
    pipe.recut((1, 3))
    assert pipe.n_stages == 3
    assert {r.rid: r.out_tokens for r in pipe.run_until_drained()} == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_engine_equals_an_exact_length_serve_engine(dtype):
    """A ServeEngine with a prefill bucket for every length and one request
    a dispatch prefills each request alone at its exact length, as a stage
    does; preempting its every lane at the step the split recuts makes it
    re-prefill what the split re-prefills.  The two then run the same
    functions on the same shapes, so their greedy tokens are equal even in
    bf16, from an engine that shares none of PipelineEngine's admission,
    preemption and re-prefill code."""
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                               n_layers=4)
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype=dtype, compute_dtype=dtype,
                                                   remat=False), device="cpu")
    tparams = tmodel.init(0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n) for n in (5, 31, 12, 24, 7, 18)]
    pipe = PipelineEngine(tmodel, tparams, max_batch=3, max_len=MAX_LEN, cuts=(2,))
    ref = ServeEngine(tmodel, tparams, max_batch=3, max_len=MAX_LEN,
                      prefill_buckets=range(1, MAX_LEN + 1), max_prefill_batch=1)
    for p in prompts:
        pipe.submit(p, max_new=8)
        ref.submit(p, max_new=8)
    for _ in range(3):
        pipe.step()
        ref.step()
    pipe.recut((1, 3))
    for slot, req in enumerate(ref.slots):
        if req is not None:
            ref.preempt(slot)
    got = {r.rid: r.out_tokens for r in pipe.run_until_drained()}
    want = {r.rid: r.out_tokens for r in ref.run_until_drained()}
    assert got == want and len(got) == len(prompts)
    assert ref.metrics_snapshot().preemptions == 3


def test_pipeline_engine_rejects_extra_inputs_and_finishes_at_admission(lm4):
    _, _, tmodel, tparams = lm4
    pipe = PipelineEngine(tmodel, tparams, max_batch=2, max_len=MAX_LEN, cuts=(2,))
    with pytest.raises(ValueError, match="extra model inputs"):
        pipe.submit(np.arange(4, dtype=np.int32), max_new=2,
                    frontend=np.zeros((2, 8), np.float32))
    pipe.submit(np.arange(1, 5, dtype=np.int32), max_new=1)
    done = pipe.run_until_drained(max_steps=5)
    assert len(done) == 1 and len(done[0].out_tokens) == 1
    assert pipe.active() == 0 and pipe.steps == 0


def test_pipeline_engine_preempt_and_forget(lm4):
    _, _, tmodel, tparams = lm4
    prompts = _greedy_traffic(tmodel.cfg.vocab_size, 3, seed=7)
    pipe = PipelineEngine(tmodel, tparams, max_batch=3, max_len=MAX_LEN, cuts=(2,))
    for p in prompts:
        pipe.submit(p, max_new=6)
    pipe.step()
    assert pipe.lane_cost(0) == (len(prompts[0]) + 2, MAX_LEN)
    moved = pipe.preempt(0, requeue=False)
    assert moved.saved_key is not None and pipe.active() == 2
    lost = pipe.forget_lane(1)
    assert lost.preemptions == 1
    with pytest.raises(ValueError, match="idle"):
        pipe.preempt(1)
    assert pipe.feasible(moved) and pipe.inject(moved) and pipe.inject(lost, force=True)
    assert sorted(r.rid for r in pipe.queue) == [0, 1]
    assert len(pipe.run_until_drained()) == 3
    pipe.reset_stats()
    assert pipe.frames_sent == 0 and pipe.steps == 0 and not pipe.finished


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------
def _profile(pkg, name, rate=20.0, link=1e6, mem=1e12):
    return pkg.DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=mem, mem_bw=1e9,
                             link_bw=link, decode_steps_per_s=rate,
                             prefill_tokens_per_s=1e5)


@pytest.mark.parametrize("mems", [(0.75, 0.75), (0.9, 0.45), (0.45, 0.9), (2.0, 2.0)],
                         ids=str)
def test_plan_decode_split_matches_reference(lm4, mems):
    model, params, tmodel, tparams = lm4
    total = param_bytes(tparams)
    devs = [_profile(tspecs, f"d{i}", mem=m * total) for i, m in enumerate(mems)]
    jdevs = [_profile(jspecs, f"d{i}", mem=m * total) for i, m in enumerate(mems)]
    got = plan_decode_split(tmodel, tparams, devs, max_batch=3, max_len=MAX_LEN)
    want = jplan_decode_split(model, params, jdevs, max_batch=3, max_len=MAX_LEN)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.feasible == want.feasible


def _decode_costs(n_blocks, mem_per_block, frame=4096.0):
    return [(1.0 / n_blocks, frame, mem_per_block)] * n_blocks


# the reference's test_partition.py decode cases: (costs, devices, fixed mem)
DECODE_CASES = {
    "paper-pair-iph11": (_decode_costs(12, 64e6), ("xeon-e3-1225v3", "iphone-11-pro"), None),
    "paper-pair-iph16": (_decode_costs(12, 64e6), ("xeon-e3-1225v3", "iphone-16"), None),
    "memory-wall": (_decode_costs(12, 300e6), ("xeon-e3-1225v3", "iphone-11-pro"), None),
    "hopeless": (_decode_costs(4, 40e9), ("xeon-e3-1225v3", "iphone-11-pro"), None),
    "three-fixed-mem": (_decode_costs(9, 1e6),
                        ("xeon-e3-1225v3", "iphone-11-pro", "iphone-16"), (5e6, 0.0, 7e6)),
    "derated": (_decode_costs(12, 1e6), ("xeon-e3-1225v3", "iphone-11-pro@8"), None),
    "base": (_decode_costs(12, 1e6), ("xeon-e3-1225v3", "iphone-11-pro"), None),
}


def _devices(pkg, names):
    out = []
    for name in names:
        name, _, slow = name.partition("@")
        p = pkg.get_profile(name)
        out.append(p.derate(float(slow)) if slow else p)
    return out


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_matches_reference(case):
    costs, names, fixed = DECODE_CASES[case]
    got = tpart.split_decode(costs, _devices(tspecs, names), stage_fixed_mem=fixed)
    want = jpart.split_decode(costs, _devices(jspecs, names), stage_fixed_mem=fixed)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.step_seconds, got.feasible) == (want.step_seconds, want.feasible)


@pytest.mark.parametrize("n_dev,n_blocks,seed", [(2, 5, 1), (3, 9, 7), (4, 12, 42),
                                                 (2, 18, 99)])
def test_split_blocks_matches_reference(n_dev, n_blocks, seed):
    rng = np.random.default_rng(seed)
    costs = [(float(f), float(b)) for f, b in
             zip(rng.uniform(1e9, 1e11, n_blocks), rng.uniform(1e4, 1e7, n_blocks))]
    names = ("xeon-e3-1225v3", "iphone-11-pro", "iphone-16", "iphone-16")[:n_dev]
    for train in (True, False):
        got = tpart.split_blocks(costs, _devices(tspecs, names), train=train)
        want = jpart.split_blocks(costs, _devices(jspecs, names), train=train)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert tpart.pipeline_batch_seconds(got, 8) == jpart.pipeline_batch_seconds(want, 8)
    assert tpart.single_device_seconds(costs, tspecs.IPHONE_16, 8) == \
        jpart.single_device_seconds(costs, jspecs.IPHONE_16, 8)


@pytest.mark.parametrize("model_axis", [4, 8, 16])
def test_plan_pipeline_matches_reference(model_axis):
    for n_layers in (2, 5, 12, 24, 36, 81, 96):
        for schedule in ("gpipe", "hybrid"):
            got = tpart.plan_pipeline(n_layers, model_axis, schedule=schedule)
            want = jpart.plan_pipeline(n_layers, model_axis, schedule=schedule)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert (got.ticks(), got.bubble_fraction()) == (want.ticks(),
                                                            want.bubble_fraction())


def test_profiles_match_reference_except_the_card():
    """The paper's Table 1 devices are the reference's; the H100 stands where
    the reference's accelerator profile stood, with every rate set."""
    for name, p in tspecs.PROFILES.items():
        if name == tspecs.H100.name:
            continue
        assert dataclasses.astuple(p) == dataclasses.astuple(jspecs.get_profile(name))
    h = tspecs.get_profile("h100-sxm")
    assert h.decode_steps_per_s > 0 and h.prefill_tokens_per_s > 0 and h.link_bw > 0
    assert h.derate(2.0).decode_steps_per_s == h.decode_steps_per_s / 2
    assert not hasattr(tspecs, "TPU_V5E")
    with pytest.raises(KeyError, match="unknown device profile"):
        tspecs.get_profile("tpu-v5e")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_boundary_frame_bytes_matches_reference(dtype):
    rc = dict(param_dtype=dtype, compute_dtype=dtype, remat=False)
    cfg = reduced_config(get_config("granite-8b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("granite-8b"))
    model = build_model(cfg, RunConfig(**rc))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(**rc), device="cpu")
    for b in (1, 3, 8):
        got = boundary_frame_bytes(tmodel, b)
        assert got == jframe_bytes(model, b)
        raw = b * tcfg.d_model * (4 if dtype == "float32" else 2)
        assert raw < got < raw + 256              # header + dims + CRC, nothing else

