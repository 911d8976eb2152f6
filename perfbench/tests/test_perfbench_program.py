"""The readers of the program's own spans and counters
(``harness/program.py`` and its eight metrics): idle gaps go to the
innermost program span, kernels replayed from a graph count where their
``cudaGraphLaunch`` was issued, the counters give means a step, and a
program without the spans or counters (the parent of this reader) gives
nothing, without raising.  ``-m cuda``: a brief traced run of each cell on
the card reads a number for every one of the eight."""

import time
import types

import pytest
import torch

from harness import program, runner, spec, yardstick
from harness.trace import Trace, reduce
from tiny import tiny_cell

NEW = {"granite-8b.batch": ("dispatch_ms.batch", "sample_wait_ms.batch",
                            "bookkeeping_ms.batch", "dispatch_idle.batch",
                            "decode_kernels.batch"),
       "granite-8b.docqa": ("prefill_dispatch_ms.docqa", "admit_idle.docqa"),
       "rwkv6-1.6b.train": ("adamw_ms.train",)}


def read(cell, metric, trace=None, **host):
    record = types.SimpleNamespace(host=host, trace=trace, yardstick=yardstick,
                                   model=None, mix=None, setup_s=1.0)
    return spec.find_cell(cell).reader(metric).read(record)


def step_trace():
    """Two engine steps in a traced slice of 0-200 ns: the first admits (a
    prefill dispatch inside admission), the second only decodes."""
    spans = [("bench.trace", 0, 200),
             ("bench.step.admit", 0, 100), ("engine.step", 1, 99),
             ("engine.prepare", 2, 5), ("engine.admit", 6, 60), ("engine.schedule", 7, 10),
             ("engine.prefill", 11, 40), ("engine.first_token", 41, 50),
             ("engine.paste", 51, 59), ("engine.prepare", 61, 63),
             ("engine.decode", 64, 80), ("engine.sample", 81, 95), ("engine.retire", 96, 98),
             ("bench.step.decode", 102, 199), ("engine.step", 102, 198),
             ("engine.prepare", 103, 105), ("engine.admit", 106, 108),
             ("engine.schedule", 106, 107), ("engine.prepare", 109, 110),
             ("engine.decode", 111, 150), ("engine.sample", 151, 190),
             ("engine.retire", 191, 197)]
    ops = [("prefill_gemm", 20, 45, 15),              # launched in the prefill
           ("decode_kernel", 70, 76, 66), ("decode_kernel", 76, 90, 70),
           ("Memcpy HtoD (Pageable -> Device)", 112, 113, 112),
           ("decode_kernel", 140, 160, 145), ("decode_kernel", 160, 180, 145),
           ("argmax", 180, 185, 152)]
    return Trace(ops, spans, [15, 66, 70, 152], 0, 200, len(ops))


def test_idle_gaps_go_to_the_innermost_program_span():
    by = program.idle_by_span(step_trace())
    # 0-20: middle 10 in engine.schedule; 45-70: middle 57 in engine.paste;
    # 90-112: middle 101 between the steps; 113-140: engine.decode;
    # 185-200: middle 192 in engine.retire
    assert by == pytest.approx({"engine.schedule": 20e-9, "engine.paste": 25e-9,
                                None: 22e-9, "engine.decode": 27e-9,
                                "engine.retire": 15e-9})
    inside = program.idle_by_span(step_trace(), within="bench.step.")
    assert None not in inside and sum(inside.values()) == pytest.approx(87e-9)


def test_innermost_of_nested_spans():
    spans = program.program_spans(Trace([], [("engine.step", 0, 100), ("engine.admit", 10, 50),
                                             ("engine.prefill", 20, 30),
                                             ("engine.decode", 60, 90)], [], 0, 100, 0))
    got = program.innermost(spans, [5, 15, 25, 35, 55, 70, 95, 120])
    assert got == ["engine.step", "engine.admit", "engine.prefill", "engine.admit",
                   "engine.step", "engine.decode", "engine.step", None]


def test_span_readers_on_a_hand_built_trace():
    tr = step_trace()
    assert read("granite-8b.batch", "dispatch_idle.batch", tr) == pytest.approx(100 * 27 / 109)
    assert read("granite-8b.docqa", "admit_idle.docqa", tr) == pytest.approx(100 * 45 / 109)
    # the second step alone admitted nothing: its two replayed kernels, not
    # its copy, and not the sampler's argmax
    assert read("granite-8b.batch", "decode_kernels.batch", tr) == 2.0


class Event:
    """A profiler event as ``harness.trace.reduce`` reads one."""

    def __init__(self, name, kind, start, dur, corr, linked=0):
        self._v = (name, kind, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_kernels_replayed_from_a_graph_count_at_their_graph_launch():
    evs = [Event("bench.trace", "user_annotation", 0, 2000, 0),
           Event("engine.step", "user_annotation", 10, 900, 0),
           Event("engine.prefill", "user_annotation", 20, 100, 0),
           Event("engine.decode", "user_annotation", 200, 300, 0),
           Event("cudaLaunchKernel", "cuda_runtime", 30, 5, 1),
           Event("cudaGraphLaunch", "cuda_runtime", 250, 20, 2),
           Event("prefill_gemm", "kernel", 40, 50, 1),
           Event("decode_gemm", "kernel", 300, 50, 2),
           Event("decode_attention", "kernel", 350, 50, 2),
           Event("engine.step", "user_annotation", 1100, 800, 0),
           Event("engine.decode", "user_annotation", 1200, 300, 0),
           Event("cudaGraphLaunch", "cuda_runtime", 1250, 20, 3),
           Event("decode_gemm", "kernel", 1300, 50, 3),
           Event("decode_attention", "kernel", 1350, 50, 3),
           Event("gpu annotation", "gpu_user_annotation", 1300, 100, 3)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    tr = reduce(prof)
    assert tr.matched == 5 and tr.launches == [30]      # a graph launch is no kernel launch
    steps = program.decode_only_steps(tr)
    assert steps == [(1100, 1900)]
    assert [o[0] for o in program.launched_in(tr, "engine.decode", steps)] == \
        ["decode_gemm", "decode_attention"]
    # the step with a prefill dispatch is left out
    assert len(program.launched_in(tr, "engine.decode")) == 4
    # a trace that ties kernel launches alone: the replayed kernels, tied to
    # nothing, count in the decode span they start after, within the step
    untied = Trace([(n, s, e, None if n.startswith("decode") else t) for n, s, e, t in tr.ops],
                   tr.spans, tr.launches, tr.start, tr.end, 1)
    assert [o[0] for o in program.launched_in(untied, "engine.decode", steps)] == \
        ["decode_gemm", "decode_attention"]
    assert program.launched_in(untied, "engine.decode") == []


PHASES = {"engine.step": (10, 0.5), "engine.prepare": (20, 0.02), "engine.admit": (10, 0.1),
          "engine.schedule": (6, 0.01), "engine.prefill": (4, 0.08),
          "engine.first_token": (4, 0.004), "engine.paste": (4, 0.004),
          "engine.decode": (10, 0.15), "engine.sample": (10, 0.2), "engine.retire": (10, 0.03)}


def test_counter_readers_are_means_a_step_or_a_dispatch():
    snap = {"phases": {n: {"calls": c, "seconds": s} for n, (c, s) in PHASES.items()}}
    assert read("granite-8b.batch", "dispatch_ms.batch", snapshot=snap) == pytest.approx(15.0)
    assert read("granite-8b.batch", "sample_wait_ms.batch", snapshot=snap) == pytest.approx(20.0)
    assert read("granite-8b.batch", "bookkeeping_ms.batch",
                snapshot=snap) == pytest.approx(6.0)
    assert read("granite-8b.docqa", "prefill_dispatch_ms.docqa",
                snapshot=snap) == pytest.approx(20.0)


def test_adamw_reader_sums_its_kernels_a_step():
    spans = [("bench.trace", 0, 1000), ("train.adamw", 100, 300), ("train.adamw", 600, 800)]
    ops = [("fwd", 0, 90, 10), ("adam_a", 150, 170, 110), ("adam_b", 170, 200, 120),
           ("adam_a", 650, 690, 610), ("bwd", 400, 500, 350)]
    tr = Trace(ops, spans, [10, 110, 120, 350, 610], 0, 1000, len(ops))
    assert read("rwkv6-1.6b.train", "adamw_ms.train", tr) == pytest.approx(90 / 1e6 / 2)


def test_a_program_without_spans_or_counters_reads_nothing():
    """The parent's trace and snapshot: only ``bench.*`` spans, no phases."""
    tr = Trace([("k", 0, 10, 0), ("k", 40, 50, 40)],
               [("bench.trace", 0, 100), ("bench.step.decode", 0, 60),
                ("bench.train.step", 0, 60), ("rwkv6_backward", 20, 50)], [0, 40], 0, 100, 2)
    snap = {"steps": 3, "slot_utilization": 0.5}
    for cell, names in NEW.items():
        for name in names:
            assert read(cell, name, tr, snapshot=snap) is None, name
            assert read(cell, name, None, snapshot=None) is None, name


def test_traced_tiny_batch_cell_reads_its_counters_on_the_cpu():
    out = runner.run_cell(tiny_cell("granite-8b.batch"), 2**31 + 303, 3.0, True,
                          torch.device("cpu"), time.perf_counter())
    got = out["metrics"]
    for name in ("dispatch_ms.batch", "sample_wait_ms.batch", "bookkeeping_ms.batch"):
        assert got[name]["value"] > 0, name
    phases = out["host"]["snapshot"]["phases"]
    assert phases["engine.step"]["calls"] == out["host"]["snapshot"]["steps"]


def test_device_copies_of_program_spans_are_no_device_ops():
    """Where a PyTorch's profiler events lack ``activity_type``, the trace
    keeps an annotation's device-side copy, over its kernels, among the
    ops: it neither closes an idle gap nor counts as a kernel."""
    tr = step_trace()
    tr.ops += [("engine.step", 100, 200, None), ("engine.decode", 112, 180, 145)]
    assert read("granite-8b.batch", "dispatch_idle.batch", tr) == pytest.approx(100 * 27 / 109)
    assert read("granite-8b.batch", "decode_kernels.batch", tr) == 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_cell_on_the_card_reads_every_new_metric(name):
    """The cell at its own size, briefly (the traced slice is a quarter of
    the window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = runner.run_cell(spec.find_cell(name), 2**31 + 304, 8.0, True,
                          torch.device("cuda", 0), time.perf_counter())
    for metric in NEW[name]:
        assert metric in out["metrics"], (metric, sorted(out["metrics"]))
