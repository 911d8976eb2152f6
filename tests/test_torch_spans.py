"""The port's spans and phase counters (``repro_torch/runtime/spans.py``):
the serving engine's phases nest as its step runs them and land in a
profile, the training step's three parts appear once a step, the kernels'
backward spans keep their names, nothing enters ``record_function`` while
no profiler records, and the phase counters stay outside the snapshot's
equality."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.launch.train import make_step_fn
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import spans
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.metrics import PHASES

FP32 = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
# each phase's parent in the engine's step
PARENT = {"engine.prepare": "engine.step", "engine.admit": "engine.step",
          "engine.schedule": "engine.admit", "engine.prefill": "engine.admit",
          "engine.first_token": "engine.admit", "engine.paste": "engine.admit",
          "engine.decode": "engine.step", "engine.sample": "engine.step",
          "engine.retire": "engine.step"}
ADMITTING = {"engine.schedule", "engine.prefill", "engine.first_token", "engine.paste"}


@pytest.fixture(scope="module")
def granite():
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                              n_layers=2)
    model = build_model(cfg, FP32, device="cpu")
    return model, model.init(0)


def _engine(granite, n=3, max_new=4):
    """An engine on a clock that ticks by the call (two runs read the same
    times), with ``n`` requests queued."""
    model, params = granite
    ticks = itertools.count()
    eng = ServeEngine(model, params, max_batch=4, max_len=48, clock=lambda: 0.01 * next(ticks))
    rng = np.random.default_rng(5)
    for i in range(n):
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=5 + 3 * i).astype(np.int32),
                   max_new=max_new)
    return eng


def _annotations(prof):
    """(name, start, end) of the profile's ``record_function`` regions."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.activity_type() == "user_annotation"]


def _parent(span, found):
    """The innermost other span of ``found`` that holds ``span``."""
    name, s, e = span
    holders = [f for f in found if f is not span and f[1] <= s and e <= f[2]]
    return max(holders, key=lambda f: f[1])[0] if holders else None


@pytest.mark.parametrize("admits", [True, False])
def test_engine_step_spans_nest_in_a_profile(granite, admits):
    eng = _engine(granite)
    if not admits:
        eng.step()                      # admits all three; the next step only decodes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    found = [a for a in _annotations(prof) if a[0].startswith("engine.")]
    names = {a[0] for a in found}
    want = set(PHASES) if admits else set(PHASES) - {"engine.prefill", "engine.first_token",
                                                     "engine.paste"}
    assert names == want
    assert [a[0] for a in found].count("engine.step") == 1
    assert [a[0] for a in found].count("engine.prepare") == 2
    for span in found:
        assert _parent(span, found) == PARENT.get(span[0]), span
    # the children follow one another in the step's order
    top = [a[0] for a in sorted(found, key=lambda a: a[1]) if PARENT.get(a[0]) == "engine.step"]
    assert top == ["engine.prepare", "engine.admit", "engine.prepare", "engine.decode",
                   "engine.sample", "engine.retire"]


def _refuse(*a, **kw):
    raise AssertionError("record_function entered with no profiler recording")


def test_no_record_function_without_a_profiler(granite, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    eng = _engine(granite)
    eng.run_until_drained()
    assert len(eng.finished) == 3
    # a kernel's backward span, on the plain version in the kernel's place
    monkeypatch.setattr(_rms, "rmsnorm_cuda", _rms.rmsnorm_plain)
    x = torch.randn(4, 8, requires_grad=True)
    ops._RMSNorm.apply(x, torch.ones(8), 1e-5).sum().backward()
    assert x.grad is not None
    with spans.span("train.adamw"):
        pass


def test_kernel_backward_span_keeps_its_name(monkeypatch):
    monkeypatch.setattr(_rms, "rmsnorm_cuda", _rms.rmsnorm_plain)
    x = torch.randn(4, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ops._RMSNorm.apply(x, torch.ones(8), 1e-5).sum().backward()
    assert [a[0] for a in _annotations(prof)] == ["rmsnorm_backward"]


def test_phase_counters_within_the_step_and_outside_equality(granite):
    eng = _engine(granite)
    eng.run_until_drained()
    snap = eng.metrics_snapshot()
    ph = snap.phases
    assert set(ph) == set(PHASES)
    steps = ph["engine.step"]
    assert steps["calls"] == snap.steps and steps["seconds"] > 0
    for name, p in ph.items():
        assert p["calls"] > 0 and 0 < p["seconds"] <= steps["seconds"], name
    assert ph["engine.prepare"]["calls"] == 2 * steps["calls"]
    assert ph["engine.prefill"]["calls"] == snap.prefill_dispatches
    inner = sum(ph[n]["seconds"] for n in PHASES if PARENT.get(n) == "engine.step")
    assert inner <= steps["seconds"]
    admit = sum(ph[n]["seconds"] for n in ADMITTING)
    assert admit <= ph["engine.admit"]["seconds"]
    # the same run again: equal snapshots, though no two runs share a second
    again = _engine(granite)
    again.run_until_drained()
    other = again.metrics_snapshot()
    assert other.phases != snap.phases
    assert other == snap
    eng.reset_stats()
    assert all(p["calls"] == 0 for p in eng.metrics_snapshot().phases.values())


def test_train_step_spans_once_a_step():
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("rwkv6-1.6b")),
                              n_layers=2)
    model = build_model(cfg, FP32, device="cpu")
    params = model.init(0)
    opt = adamw.init(params)
    step = make_step_fn(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    params, opt, _ = step(params, opt, {"tokens": tokens})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            params, opt, stats = step(params, opt, {"tokens": tokens})
    found = sorted((a for a in _annotations(prof) if a[0].startswith("train.")),
                   key=lambda a: a[1])
    assert [a[0] for a in found] == ["train.forward", "train.backward", "train.adamw"] * 2
    assert all(a[2] <= b[1] for a, b in zip(found, found[1:]))      # one after another
    assert torch.isfinite(stats["loss"])
