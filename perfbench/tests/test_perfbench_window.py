"""The window's arithmetic: a rate over all the work and all the time of
the window, the whole step's share of the peak and the device's idle share
with the traced slice left out, the stratified generator's fixed sets."""

import types

import numpy as np
import pytest

from harness import generate, readers, spec, yardstick
from harness.serving import StepRecord
from harness.trace import Tracer

CELL = spec.find_cell("granite-8b.batch")


def record(trace=None, **host):
    return types.SimpleNamespace(host=host, yardstick=yardstick, trace=trace,
                                 model=CELL.config["model"], mix=CELL.traffic, setup_s=1.0)


def test_rate_is_all_tokens_over_the_whole_window():
    r = record(tokens=3000, window_s=40.0, requests=[(100, 10)] * 3, steps=[])
    assert CELL.reader("batch_tok_s").read(r) == pytest.approx(75.0)


def test_decode_step_median_leaves_out_admitting_and_traced_steps():
    steps = [StepRecord(0, 0.02, "step.decode", False, 0, 0, False),
             StepRecord(0, 0.03, "step.decode", False, 0, 0, False),
             StepRecord(0, 0.5, "step.admit", True, 0, 0, False),
             StepRecord(0, 0.9, "step.decode", False, 0, 0, True),
             StepRecord(0, 0.04, "step.decode", False, 0, 0, False)]
    assert CELL.reader("decode_step_ms.batch").read(record(steps=steps)) == pytest.approx(30.0)


def test_stratified_sizes_are_the_same_set_for_every_seed():
    spec_ = {"dist": "lognormal", "median": 384, "sigma": 0.6, "min": 128, "max": 1536}
    a = generate.stratified(spec_, 128, 64, generate.rng_for(1, "p"))
    b = generate.stratified(spec_, 128, 64, generate.rng_for(2**31 + 9, "p"))
    assert not np.array_equal(a, b)
    assert sorted(a[:64]) == sorted(b[:64]) == sorted(a[64:])
    assert a.min() >= 128 and a.max() <= 1536


def test_offline_queue_is_seeded():
    mix = CELL.traffic
    a = generate.offline({**mix, "requests": 8, "block": 8}, 3, 1000)
    b = generate.offline({**mix, "requests": 8, "block": 8}, 3, 1000)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


def test_idle_gaps_go_to_the_innermost_span():
    from harness.trace import Trace
    ops = [("k", 0, 10, 0), ("k", 40, 50, 40), ("k", 90, 100, 90)]
    spans = [("bench.trace", 0, 100), ("bench.step.admit", 0, 60), ("bench.prefill", 5, 20),
             ("bench.step.decode", 62, 95)]
    tr = Trace(ops, spans, [0, 40, 90], 0, 100, 3)
    gaps = dict(tr.idle_gaps())
    # 10-40: its middle, 25, is after the prefill ended, inside the admitting step
    assert gaps == pytest.approx({"step.admit": 30e-9, "step.decode": 40e-9})


def test_untraced_seconds_leave_out_the_slice():
    tr = Tracer(False)
    assert tr.untraced_s(10.0, 60.0) == pytest.approx(50.0)
    tr.t_begin, tr.t_end = 30.0, 36.5
    assert tr.untraced_s(10.0, 60.0) == pytest.approx(43.5)
    tr.t_end = 70.0                       # stopped after the window closed
    assert tr.untraced_s(10.0, 60.0) == pytest.approx(20.0)


def test_serving_mfu_leaves_out_the_traced_slice():
    """The work between the slice's start and stop, and its seconds, are
    left out: the same rate as a run with no slice."""
    whole = record(requests=[(100, 10), (200, 5)], window_s=40.0,
                   untraced={"seconds": 40.0, "steps": {}, "at_start": [], "at_stop": []})
    f = readers.serve_flops(CELL.config["model"], 100, 10) \
        + readers.serve_flops(CELL.config["model"], 200, 5)
    assert CELL.reader("mfu.batch").read(whole) == pytest.approx(
        100 * f / 40.0 / yardstick.PEAK_BF16_FLOPS)
    # (100, 4) served before the slice, (100, 7) by its stop, 30 s outside it
    sliced = record(requests=[(100, 10)], window_s=40.0,
                    untraced={"seconds": 30.0, "steps": {}, "at_start": [(100, 4)],
                              "at_stop": [(100, 7)]})
    m = CELL.config["model"]
    f = readers.serve_flops(m, 100, 10) - readers.serve_flops(m, 100, 7) \
        + readers.serve_flops(m, 100, 4)
    assert CELL.reader("mfu.batch").read(sliced) == pytest.approx(
        100 * f / 30.0 / yardstick.PEAK_BF16_FLOPS)


def test_train_mfu_counts_untraced_steps_only():
    cell = spec.find_cell("rwkv6-1.6b.train")
    r = record(params_nonembed=1e9, window_s=50.0,
               untraced={"seconds": 40.0, "steps": {"train.step": 20}, "tokens": 20 * 8192})
    assert cell.reader("mfu.train").read(r) == pytest.approx(
        100 * 6e9 * 20 * 8192 / 40.0 / yardstick.PEAK_BF16_FLOPS)


def test_idle_share_takes_busy_per_step_from_the_trace_and_time_from_outside_it():
    """Two traced decode steps busy 4 and 6 ns of device time (a copy and
    a kernel of one step overlap), one admitting step 20 ns; outside the
    slice 10 decode and 2 admitting steps ran in 200 ns: 90 ns busy."""
    from harness.trace import Trace
    ops = [("k", 0, 3, 1), ("copy", 2, 4, 2), ("k", 10, 16, 11), ("k", 30, 50, 31)]
    spans = [("bench.step.decode", 0, 5), ("bench.step.decode", 9, 17),
             ("bench.step.admit", 29, 51)]
    tr = Trace(ops, spans, [1, 11, 31], 0, 60, 4)
    r = record(trace=tr, untraced={"seconds": 200e-9,
                                   "steps": {"step.decode": 10, "step.admit": 2}})
    assert CELL.reader("idle_share.batch").read(r) == pytest.approx(100 * (1 - 90 / 200))
    # a kind of step the slice did not show takes the mean of all traced steps
    r.host["untraced"]["steps"]["step.other"] = 3
    assert CELL.reader("idle_share.batch").read(r) == pytest.approx(
        100 * (1 - (90 + 3 * 30 / 3) / 200))
