#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                     # from the root of a checkout

Phases, each of which raises on failure (the script then exits nonzero):

1. require a CUDA device; print ``nvidia-smi``'s card name and power limit;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at
   granite-8b shapes, and time kernel, plain version and a library call;
4. reduced granite in fp32 with the same weights on the card (kernels) and
   on the CPU (plain versions): logits and greedy ServeEngine tokens agree;
5. a narrow granite in bf16 (granite-8b's attention geometry and vocab,
   d_model 1024, 4 layers) on the card against the same weights on the CPU:
   bucketed right-padded prefill and decode logits agree, and every token
   the card's ServeEngine serves is a greedy choice of the CPU model;
6. full-width granite-8b (36 layers, bf16, random seeded weights) served
   through ServeEngine: 16 requests, every kernel's launch count rises;
   then the decode step, a prefill dispatch and the sampler are timed.

The line before the last is a JSON object of per-kernel numbers, the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the checkout beside it, the script exits nonzero and prints no
result.  ``--phases`` runs a subset (default: all).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

# bf16 kernel vs plain version: |a - b| <= BF16_TOL * max(1, |b|) elementwise;
# both round an fp32 result to bf16 (8 mantissa bits), so one ulp apart is
# 2^-7 relative -- 2e-2 leaves room for the different summation order
BF16_TOL = 2e-2
# fp32 kernel vs plain version: same math, different summation order
F32_TOL = 1e-4
# fp32 model logits card vs CPU (|logits| ~ 10): per-op differences of a few
# ulp from reordered sums, compounded over 4 layers; TF32 is off on both
MODEL_TOL = 1e-4
# bf16 model logits card vs CPU, absolute (logits have std ~1, max ~20):
# every op rounds its output to 8 mantissa bits (2^-8 relative) and the two
# devices sum in different orders, so the runs drift apart by some bf16 ulps
# of the largest logits; phase 5 prints how far each run lies from an fp32
# run of the same weights (the CPU's own bf16 rounding) beside this bound.
# A fault of masking, padding or indexing moves logits by O(1).
BF16_MODEL_TOL = 0.25

PHASES = ("build", "kernels", "parity", "parity_bf16", "serve")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"{msg}  [t={time.perf_counter() - _T0:.1f}s]", flush=True)


def sync_time_ms(fns, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of one call, by CUDA events over ``iters`` calls; ``fns``
    cycles through input sets so inputs can be kept colder than L2."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int, cold_bytes: int = 120 << 20) -> int:
    """Input copies to cycle so one launch's inputs leave the 50 MB L2."""
    return min(8, max(1, -(-cold_bytes // max(1, bytes_per_set))))


def bound(flops: float, flops_peak: float, nbytes: float):
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, tol: float,
                relative: bool) -> float:
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                             f"or non-finite output")
    err = (got - ref).abs()
    limit = tol * ref.abs().clamp_min(1.0) if relative else torch.full_like(ref, tol)
    if (err > limit).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} beyond tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} libraries in {time.perf_counter() - t0:.1f} s "
        f"under {_build.build_dir()}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _rand(shape, dtype, gen, dev="cuda"):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def _sdpa_gqa(q, k, v, **kw):
    """q (B,T,H,D), k/v (B,Tk,G,D): PyTorch's fused attention as a yardstick."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)


def phase_kernels(results: dict) -> None:
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krms
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    # -- rmsnorm: (8192, 4096) prefill-sized and (8, 4096) decode-sized rows
    for rows in (8192, 8):
        d = 4096
        sets = [(_rand((rows, d), bf, gen), (1 + 0.1 * _rand((d,), torch.float32, gen)).to(bf))
                for _ in range(n_sets(rows * d * 2 * 2))]
        x, s = sets[0]
        err = check_close(f"rmsnorm {rows}x{d} bf16", krms.rmsnorm_cuda(x, s),
                          krms.rmsnorm_plain(x, s), BF16_TOL, relative=True)
        x32, s32 = x.float(), s.float()
        check_close(f"rmsnorm {rows}x{d} f32", krms.rmsnorm_cuda(x32, s32),
                    krms.rmsnorm_plain(x32, s32), F32_TOL, relative=False)
        ms = sync_time_ms([lambda a=a, b=b: krms.rmsnorm_cuda(a, b) for a, b in sets])
        plain_ms = sync_time_ms([lambda a=a, b=b: krms.rmsnorm_plain(a, b) for a, b in sets])
        lib_ms = sync_time_ms([lambda a=a, b=b: F.rms_norm(a, (d,), b, 1e-5) for a, b in sets])
        b_ms, b_by = bound(4.0 * rows * d, PEAK_F32_FLOPS, rows * d * 2 * 2 + d * 2)
        log(f"[kernels] rmsnorm ({rows},{d}) bf16: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        if rows == 8192:
            results["rmsnorm"] = dict(
                name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:25", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape=f"x ({rows},{d}) bf16")

    # -- flash attention: B=2, H=32, G=8, D=128, causal, T=1024 and ragged 1000
    b, h, g, d = 2, 32, 8, 128
    for t in (1024, 1000):
        q, k, v = (_rand((b, t, n, d), bf, gen) for n in (h, g, g))
        err = check_close(f"flash T={t} bf16", kfa.flash_attention_cuda(q, k, v),
                          kfa.flash_attention_plain(q, k, v), BF16_TOL, relative=True)
        q32, k32, v32 = q.float(), k.float(), v.float()
        check_close(f"flash T={t} f32", kfa.flash_attention_cuda(q32, k32, v32),
                    kfa.flash_attention_plain(q32, k32, v32), F32_TOL, relative=False)
        ms = sync_time_ms([lambda: kfa.flash_attention_cuda(q, k, v)], iters=10)
        plain_ms = sync_time_ms([lambda: kfa.flash_attention_plain(q, k, v)], iters=5)
        lib_ms = sync_time_ms([lambda: _sdpa_gqa(q, k, v, is_causal=True)], iters=10)
        pairs = t * (t + 1) // 2                      # causal (query, key) pairs per head
        b_ms, b_by = bound(4.0 * b * h * d * pairs, PEAK_BF16_FLOPS,
                           2 * (b * t * h * d + 2 * b * t * g * d))
        log(f"[kernels] flash B={b} T={t} H={h} G={g} D={d} causal bf16: max_abs_err "
            f"{err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})")
        if t == 1024:
            results["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:88", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape=f"B={b} T={t} H={h} G={g} D={d} causal bf16")

    # -- decode attention: B=8 lanes, S=1024, random per-lane filled length
    b, s = 8, 1024
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[1] = 1, s                           # the two extremes
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    scattered = (torch.rand((b, s), generator=gen, device="cuda") < 0.3) | (
        torch.arange(s, device="cuda")[None, :] == 0)
    scale = d ** -0.5
    kv_bytes = 2 * b * s * g * d * 2
    sets = [(_rand((b, 1, h, d), bf, gen), _rand((b, s, g, d), bf, gen),
             _rand((b, s, g, d), bf, gen)) for _ in range(n_sets(kv_bytes))]
    q, ck, cv = sets[0]
    err = 0.0
    for name, mask in (("prefix", valid), ("scattered", scattered)):
        err = max(err, check_close(f"decode {name} bf16",
                                   kdec.decode_attention_cuda(q, ck, cv, mask, scale),
                                   kdec.decode_attention_plain(q, ck, cv, mask, scale),
                                   BF16_TOL, relative=True))
        q32, ck32, cv32 = q.float(), ck.float(), cv.float()
        check_close(f"decode {name} f32", kdec.decode_attention_cuda(q32, ck32, cv32, mask, scale),
                    kdec.decode_attention_plain(q32, ck32, cv32, mask, scale), F32_TOL,
                    relative=False)
    ms = sync_time_ms([lambda a=a: kdec.decode_attention_cuda(a[0], a[1], a[2], valid, scale)
                       for a in sets])
    plain_ms = sync_time_ms([lambda a=a: kdec.decode_attention_plain(a[0], a[1], a[2], valid,
                                                                     scale) for a in sets])
    mask4 = valid[:, None, None, :]
    lib_ms = sync_time_ms([lambda a=a: _sdpa_gqa(a[0], a[1], a[2], attn_mask=mask4)
                           for a in sets])
    live = int(valid.sum().item())                    # positions this data needs read
    b_ms, b_by = bound(4.0 * h * d * live, PEAK_BF16_FLOPS,
                       2 * live * g * d * 2 + 2 * 2 * b * h * d + b * s)
    log(f"[kernels] decode B={b} S={s} H={h} G={g} D={d} bf16 ({live} live positions): "
        f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:64", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B={b} S={s} H={h} G={g} D={d} bf16, {live} live positions")


# ---------------------------------------------------------------------------
# phases 4-5: card vs CPU, fp32 and bf16
# ---------------------------------------------------------------------------

def _serve(model, params, prompts, max_new, **engine_kw):
    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(model, params, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    done = eng.run_until_drained()
    return {r.rid: r.out_tokens for r in done}, eng


def phase_parity(n_layers: int = 4) -> None:
    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.convert import move_params
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=n_layers)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    cpu, gpu = build_model(cfg, rcfg, device="cpu"), build_model(cfg, rcfg, device="cuda")
    p_cpu = cpu.init(0)
    p_gpu = move_params(p_cpu, "cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 40)), dtype=torch.int64)
    lens = torch.as_tensor([13, 40], dtype=torch.int32)
    ops.reset_launch_counts()
    worst = 0.0
    with torch.no_grad():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 64)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 64)
        worst = max(worst, check_close("prefill logits", l_g.cpu(), l_c, MODEL_TOL, False))
        for i in range(4):
            nxt = torch.argmax(l_c[:, :cfg.vocab_size], -1)[:, None]
            if not torch.equal(nxt, torch.argmax(l_g[:, :cfg.vocab_size], -1)[:, None].cpu()):
                raise AssertionError(f"decode step {i}: card and CPU argmax differ")
            l_c, c_c = cpu.decode_step(p_cpu, c_c, nxt)
            l_g, c_g = gpu.decode_step(p_gpu, c_g, nxt.cuda())
            worst = max(worst, check_close(f"decode {i} logits", l_g.cpu(), l_c, MODEL_TOL,
                                           False))
        l_c, _ = cpu.decode_state.batched_prefill(p_cpu, {"tokens": toks}, lens, 64)
        l_g, _ = gpu.decode_state.batched_prefill(p_gpu, {"tokens": toks.cuda()},
                                                  lens.cuda(), 64)
        worst = max(worst, check_close("padded prefill logits", l_g.cpu(), l_c, MODEL_TOL,
                                       False))
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 17, 33, 9)]
        kw = dict(max_batch=2, max_len=64)
        t_cpu, _ = _serve(cpu, p_cpu, prompts, 8, **kw)
        t_gpu, _ = _serve(gpu, p_gpu, prompts, 8, **kw)
    counts = ops.launch_counts()
    if t_cpu != t_gpu:
        raise AssertionError(f"greedy tokens differ card vs CPU: {t_gpu} vs {t_cpu}")
    if min(counts.values()) == 0:
        raise AssertionError(f"parity run missed a kernel: {counts}")
    log(f"[parity] reduced granite fp32 ({n_layers} layers): card vs CPU logits max |err| "
        f"{worst:.3e} (tol {MODEL_TOL}); greedy ServeEngine tokens identical for "
        f"{len(t_cpu)} requests; launches {counts}")


def phase_parity_bf16(n_layers: int = 4) -> None:
    """The bf16 serving path (tensor-core flash kernel, bucketed prefill with
    right padding, lane pastes, batched decode) against the CPU's plain
    versions on the same bf16 weights."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import move_params, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    # granite-8b's heads (32 over 8 KV heads, head_dim 128), vocab, tied head
    # and RoPE; width and depth cut so that the CPU runs take seconds
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=n_layers, d_model=1024,
                              d_ff=3584)
    rb = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", remat=False)
    r32 = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    cpu, gpu = build_model(cfg, rb, device="cpu"), build_model(cfg, rb, device="cuda")
    ref = build_model(cfg, r32, device="cpu")
    p_cpu = cpu.init(0)
    p_gpu, p_32 = move_params(p_cpu, "cuda"), tree_map(lambda t: t.float(), p_cpu)
    v, max_len = cfg.vocab_size, 128
    rng = np.random.default_rng(1)
    lens = [5, 17, 40, 64]                            # one 64-wide bucket, right-padded
    toks = torch.zeros((len(lens), 64), dtype=torch.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.as_tensor(rng.integers(0, v, size=n))
    lens_t = torch.as_tensor(lens, dtype=torch.int32)
    worst, cpu_drift, gpu_drift = 0.0, 0.0, 0.0

    def compare(name, l_g, l_c, l_r):
        nonlocal worst, cpu_drift, gpu_drift
        l_g, l_c, l_r = l_g.cpu().float()[:, :v], l_c.float()[:, :v], l_r[:, :v]
        worst = max(worst, check_close(name, l_g, l_c, BF16_MODEL_TOL, False))
        cpu_drift = max(cpu_drift, (l_c - l_r).abs().max().item())
        gpu_drift = max(gpu_drift, (l_g - l_r).abs().max().item())

    ops.reset_launch_counts()
    with torch.no_grad():
        l_g, c_g = gpu.decode_state.batched_prefill(p_gpu, {"tokens": toks.cuda()},
                                                    lens_t.cuda(), max_len)
        l_c, c_c = cpu.decode_state.batched_prefill(p_cpu, {"tokens": toks}, lens_t, max_len)
        l_r, c_r = ref.decode_state.batched_prefill(p_32, {"tokens": toks}, lens_t, max_len)
        compare("bf16 padded prefill logits", l_g, l_c, l_r)
        exact = torch.cat([cpu.prefill(p_cpu, {"tokens": toks[i:i + 1, :n]}, max_len)[0]
                           for i, n in enumerate(lens)])
        compare("bf16 padded prefill vs exact-length prefill", l_g, exact, l_r)
        for i in range(4):
            nxt = torch.argmax(l_r[:, :v], -1)[:, None]
            l_g, c_g = gpu.decode_step(p_gpu, c_g, nxt.cuda())
            l_c, c_c = cpu.decode_step(p_cpu, c_c, nxt)
            l_r, c_r = ref.decode_step(p_32, c_r, nxt)
            compare(f"bf16 decode {i} logits", l_g, l_c, l_r)

        # greedy serving on the card over four buckets; each served token
        # must be a greedy choice of the CPU's plain model fed the same
        # tokens, up to two logits' worth of the bf16 tolerance
        prompts = [rng.integers(0, v, size=n) for n in (5, 12, 17, 30, 33, 60, 70, 100)]
        served, eng = _serve(gpu, p_gpu, prompts, 8, max_batch=4, max_len=max_len)
        exact_argmax = n_tokens = 0
        for rid, prompt in enumerate(prompts):
            out = served[rid]
            logits, cache = cpu.prefill(p_cpu, {"tokens": torch.as_tensor(prompt)[None]},
                                        max_len)
            for j, tok in enumerate(out):
                row = logits[0, :v].float()
                if row[tok] < row.max() - 2 * BF16_MODEL_TOL:
                    raise AssertionError(f"request {rid} token {j}: the card served {tok} "
                                         f"(CPU logit {row[tok]:.4f}), the CPU's best logit "
                                         f"is {row.max():.4f}")
                exact_argmax += int(tok == int(torch.argmax(row)))
                n_tokens += 1
                if j + 1 < len(out):
                    logits, cache = cpu.decode_step(p_cpu, cache, torch.tensor([[tok]]))
    counts = ops.launch_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f"bf16 parity run missed a kernel: {counts}")
    snap = eng.metrics_snapshot()
    log(f"[parity-bf16] granite geometry, d_model {cfg.d_model}, {n_layers} layers, bf16: "
        f"card vs CPU logits max |err| {worst:.4f} (tol {BF16_MODEL_TOL}); distance from an "
        f"fp32 CPU run: card {gpu_drift:.4f}, CPU bf16 {cpu_drift:.4f}; {len(prompts)} "
        f"served requests in {snap.prefill_dispatches} prefill dispatches, {n_tokens} "
        f"tokens all greedy choices of the CPU model ({exact_argmax} its exact argmax); "
        f"launches {counts}")


# ---------------------------------------------------------------------------
# phase 6: full-width granite-8b through ServeEngine
# ---------------------------------------------------------------------------

def phase_serve(results: dict, n_layers: int = 0, n_requests: int = 16,
                max_new: int = 32) -> None:
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeEngine
    cfg = get_config("granite-8b")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rcfg = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", remat=False)
    model = build_model(cfg, rcfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] granite-8b {cfg.n_layers} layers d_model {cfg.d_model}: {n_params} params "
        f"({n_params * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    max_batch, max_len = 8, 1024
    eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        eng.submit(rng.integers(0, cfg.vocab_size, size=20), max_new=4)   # warm-up
        eng.run_until_drained()
        torch.cuda.synchronize()
        eng.reset_stats()
        lengths = np.linspace(16, 600, n_requests).astype(int)
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
        buckets = sorted({eng._bucket_len(n) for n in lengths})
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new=max_new)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()

        if len(done) != n_requests or any(len(r.out_tokens) != max_new for r in done):
            raise AssertionError(f"{len(done)}/{n_requests} requests finished with "
                                 f"{[len(r.out_tokens) for r in done]} tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
            raise AssertionError("a generated token lies outside the vocabulary")
        missed = [k for k, n in counts.items() if n == 0]
        if missed:
            raise AssertionError(f"the serving run never launched {missed}: {counts}")
        snap = eng.metrics_snapshot()
        gen_tokens = sum(len(r.out_tokens) for r in done)
        log(f"[serve] {n_requests} requests, prompts {int(lengths.min())}-{int(lengths.max())} "
            f"tokens in buckets {buckets}, max_new {max_new}, max_batch {max_batch}, "
            f"max_len {max_len}: {gen_tokens} tokens in {wall:.3f} s = "
            f"{gen_tokens / wall:.1f} tok/s; {snap.prefill_dispatches} prefill dispatches, "
            f"{snap.steps} decode steps")
        log(f"[serve] TTFT mean {snap.ttft.mean * 1e3:.1f} ms p50 {snap.ttft.p50 * 1e3:.1f} ms "
            f"p95 {snap.ttft.p95 * 1e3:.1f} ms; TPOT mean {snap.tpot.mean * 1e3:.2f} ms; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[serve] launches on the main path: {counts}")

        # per-step launch counts and the decode-step time at a full batch
        toks = np.zeros((max_batch, 1), np.int32)
        active = np.ones((max_batch,), bool)
        ops.reset_launch_counts()
        logits = eng.backend.step(params, toks, active)
        per_step = ops.launch_counts()
        if logits.shape != (max_batch, 49152) or not torch.isfinite(logits).all():
            raise AssertionError(f"decode logits {tuple(logits.shape)} not finite or not "
                                 f"({max_batch}, 49152)")
        step_ms = sync_time_ms([lambda: eng.backend.step(params, toks, active)], iters=10,
                               warmup=2)
        sample_ms = time_sampler(logits[:, :cfg.vocab_size], max_batch)
        ops.reset_launch_counts()
        model.prefill(params, {"tokens": torch.zeros((1, 128), dtype=torch.int64,
                                                     device=model.device)}, max_len)
        per_prefill = ops.launch_counts()
    log(f"[serve] decode step at batch {max_batch}: {step_ms:.3f} ms; launches per decode "
        f"step {per_step}; per prefill dispatch {per_prefill}")
    log(f"[serve] sampling {max_batch} lanes of {cfg.vocab_size} logits, host clock per "
        f"call (the tokens' copy to the host included): greedy {sample_ms['greedy']:.3f} ms, "
        f"stochastic (temperature 0.8, top_k 50, top_p 0.95) "
        f"{sample_ms['stochastic']:.3f} ms")
    profile_step(lambda: eng.backend.step(params, toks, active), "decode step, batch 8")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 512)),
                             device=model.device)
    lens = torch.full((4,), 512, dtype=torch.int32, device=model.device)
    profile_step(lambda: model.decode_state.batched_prefill(params, {"tokens": prompt}, lens,
                                                            max_len),
                 "prefill dispatch, 4 x 512 tokens")
    for name, n in counts.items():
        results.setdefault(name, {"name": name})["launches"] = n


def time_sampler(logits: torch.Tensor, n_lanes: int, iters: int = 10) -> dict:
    """Host ms of one ``Sampler.sample`` over ``logits`` with every lane
    greedy, then with every lane stochastic (seeded, one seed per lane)."""
    from repro_torch.serving.sampling import Sampler, SamplingParams
    sampler, out = Sampler(n_lanes), {}
    for kind in ("greedy", "stochastic"):
        if kind == "stochastic":
            for lane in range(n_lanes):
                sampler.set_lane(lane, SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                                      seed=lane))
        toks = sampler.sample(logits)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            toks = sampler.sample(logits)
        out[kind] = (time.perf_counter() - t0) * 1e3 / iters
        if toks.shape != (n_lanes,) or not ((0 <= toks) & (toks < logits.shape[-1])).all():
            raise AssertionError(f"{kind} sampling gave tokens {toks}")
    return out


def profile_step(fn, what: str, top: int = 8) -> None:
    """Device time by kernel over three calls of ``fn`` (torch.profiler,
    device activity only) against the unprofiled wall time of a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    # kernel rows only: an aten op's row repeats the time of the kernels it ran
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 3
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms per call, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {sum(r[1] for r in rows) // 3} "
        f"kernel launches")
    for t_us, n, key in rows[:top]:
        log(f"[profile]   {t_us / 3 / 1e3:8.3f} ms  {n // 3:5d} launches  {key[:90]}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    results: dict = {}
    t_start = time.perf_counter()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(results)
    if "parity" in phases:
        phase_parity()
    if "parity_bf16" in phases:
        phase_parity_bf16()
    if "serve" in phases:
        phase_serve(results)
    kernels = [dict(r, launches=r.get("launches")) for r in results.values()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
