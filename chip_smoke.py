#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                     # from the root of a checkout

Phases, each of which raises on failure (the script then exits nonzero):

1. require a CUDA device; print ``nvidia-smi``'s card name and power limit;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card at
   granite-8b shapes (flash also at a serving bucket, B 8 x T 128), the
   rwkv6 kernel at rwkv6-1.6b's training shape and the SSD kernel, flash
   (head_dim 112) and RMSNorm at zamba2-7b's (the decode kernel also on a
   lane with no valid position, the paged kernel over 16 lanes' block
   tables with shared blocks, both decode kernels at head_dim 112 in bf16
   and fp32, the rwkv6 and SSD kernels also against their token
   recurrences under strong decay, each of their gates' margin printed),
   and time kernel, plain version and a library call (and the rwkv6 and
   SSD backwards: WKV6's backward kernel at 8 x 1024 and 8 x 512 against
   the plain VJP, all five gradients, beside its bound); every kernel also
   by its device time alone
   (torch.profiler), beside the library call's, and SSD and WKV6 against
   their bounds on tensor cores and as fp32 vector work; then flash, both
   decode kernels and RMSNorm at the shapes the other families give them
   (``FAMILY_FLASH`` ... ``FAMILY_RMS``: whisper's non-causal encoder and
   its cross-attention over 1500 frames, at a prefill and at its gspmd_tp
   training microbatch of 4, internvl2's D=64 at H/G 7,
   llama4's 8192-token chunks at H/G 5, grok's H/G 6, ...), each against
   its plain version, its bound and SDPA or ``F.rms_norm``;
4. reduced granite in fp32 with the same weights on the card (kernels) and
   on the CPU (plain versions): logits and greedy ServeEngine tokens agree,
   over dense lanes and over the paged pool with the prefix cache (a run
   with full hits, a COW split, preemptions and a rejection); then reduced
   rwkv6 and zamba2 (4 layers) over the recurrent backend: prefill logits
   and every state leaf at B=1 and exact lengths 1-100, decode logits,
   identical greedy tokens, and a run with a preempted lane resumed from
   its snapshot (one prefill dispatch a request); then each arch this
   slice brings (whisper-small, internvl2-1b, llama4-scout, grok-1,
   command-r-35b, mistral-nemo-12b, yi-34b) and the pure-SSM family,
   reduced, fp32: logits and greedy ServeEngine tokens card vs CPU, and
   for MoE every routing call's picks and kept mask identical (the
   smallest top-k probability gap printed);
5. a narrow granite in bf16 (granite-8b's attention geometry and vocab,
   d_model 1024, 4 layers) on the card against the same weights on the CPU:
   bucketed right-padded prefill and decode logits agree, and every token
   the card's dense and paged ServeEngines serve is a greedy choice of the
   CPU model; then the recurrent checks of phase 4 in bf16;
6. full-width granite-8b (36 layers, bf16, random seeded weights) served
   through ServeEngine over dense lanes: 16 requests, every kernel of the
   dense path launched; then the decode step, a prefill dispatch and the
   sampler are timed, and the profile of a decode step gives the decode
   kernel's share of the device time;
7. the same weights served over the paged pool with the prefix cache: 32
   chat requests behind a shared 512-token system prompt, then 4 repeats
   (full hits), on a pool small enough to preempt; the paged kernel runs 36
   times a decode step and the dense decode kernel never; the profile of an
   engine step at batch 16 gives the paged kernel's share;
8. ``serve_stages``: the same weights split into layer-range stages, all
   on the card: a ``PipelineEngine`` (max_batch 8, max_len 1024) at the cut
   ``plan_decode_split`` picks for an H100 and an iPhone 16, serving phase
   6's 16 requests, recut after 6 steps to the plan for an H100 and two
   iPhone 16s; its tokens equal a one-stage engine's bit for bit (every
   lane preempted at the same step) and a ServeEngine's that prefills each
   request alone at its exact length and preempts at the same step, and
   both split and one-stage runs launch exactly the
   unsplit model's kernels per prefill dispatch and decode step; each
   kernel against its plain version at the stage shapes; tok/s, TTFT,
   TPOT, each stage's decode wall, frames and bytes per boundary, the
   recut's bytes and time, and the card's readings for the H100
   ``DeviceProfile`` (a boundary frame's host round trip, decode steps and
   prefill tokens a second);
9. ``agent``: the paper's §4.3 tool loop on the same weights over the paged
   pool with the prefix cache, a 100,000 x 384 vector DB behind 3 tool
   workers at 0.5 s a search, async and sync tools, with a 0 and a
   512-token scenario prefix: async tool wait under half of sync's, the
   same tokens, prefix hits; each kernel against its plain version at the
   agent's shapes;
10. ``serve_rwkv`` and ``serve_hybrid``: rwkv6-1.6b (24 layers) and zamba2-7b
   (all 81 layers) at full width, bf16, random seeded weights, served over
   the recurrent backend with phase 6's engine and traffic, one lane
   preempted and resumed by restore (bit-equal to its snapshot); tok/s,
   TTFT, TPOT, the decode step's wall and device time, the state a lane
   holds and the snapshot and restore times; then every kernel of the
   path against its plain version at the shapes it serves (B=1 prefills
   of 37 and 600 tokens, a decode step of 8 lanes over 1024 positions);
11. ``parity_train``: reduced rwkv6, granite and zamba2 (4 layers, fp32),
   and rwkv6-1.6b and zamba2-7b at full width cut to 2 layers, the same
   weights on the card (kernels, their gradients through the autograd
   wrappers) and on the CPU (plain versions): loss, every gradient leaf and
   the losses of 3 AdamW steps agree;
12. ``train``: full-width rwkv6-1.6b (24 layers, bf16, random seeded
   weights) trained 20 steps through the launcher's ``Trainer``, step
   function and AdamW on 8 x 512-token ``TokenPipeline`` batches; one
   checkpoint written, restored and found bit-equal; step time, tok/s,
   MFU, peak memory and a profile of a step;
13. ``train_hybrid``: zamba2-7b at full width cut to 42 layers (seven
   periods of its shared block; the whole model's params, grads and
   moments do not fit one card), bf16, trained 10 steps the same way, no
   checkpoint; step time, tok/s, MFU, peak memory and a profile of a step
   (the SSD, flash and RMSNorm backwards, and the step's forward and
   AdamW, read from their spans);
14. ``resnet``: ResNet-34 (the paper's §4.1 model) at 224 px in fp32: the
   forward, loss and every gradient on the card against the CPU on one set
   of params; the calibrated reproduction table of the paper's appendix
   A.1 beside this card's batch of 128 in 8 microbatches of 16 (forward,
   and forward + backward, by CUDA events, against the fp32 FLOP bound);
   the reference bench's 2-stage cut at ``len(params) // 2``;
15. ``train_pp``: the pipeline-parallel trainer on an emulated (1, 2) mesh:
   the gpipe and hybrid pipelined steps against the unsplit step in fp32
   (granite-8b and rwkv6-1.6b at full width cut to 4 layers, zamba2-7b to
   12): loss, every gradient leaf, grad_norm, 3 AdamW steps, exact
   launches; then rwkv6-1.6b at full width and depth, bf16, remat, hybrid
   over 2 stages in 4 microbatches of 2 x 512 tokens, 10 steps through the
   Trainer: a falling held-out loss, the ticks and bubble, boundary bytes
   per tick, the stash, the peak memory and the step time beside the
   unsplit step's;
16. ``serve_spec`` (run after ``agent``, on phase 6's weights): speculative
   decoding through ``SpecEngine``, k 3, the frames through the codec, each
   run beside a plain witness engine on the same requests (both prefill
   each request alone at its exact length, so admission timing changes no
   shape): (a) granite-8b with its 4-layer prefix drafting, phase 6's 16
   requests half stochastic: tokens bit-equal to the witness's, launches
   exactly those of the prefills, (k + 1) target and (1 + k) draft steps a
   round (also one steady round alone), acceptance, tokens a round, tok/s
   and TPOT beside the witness's, frame bytes each way, a profiled round;
   (a2) the prefix under a random head of its own, which misses: the same
   tokens and exact launches; (b) the target as its own draft: acceptance
   exactly 1.0 and the witness's tokens; (c) granite-8b's full width cut
   to 4 layers, fp32, a 2-layer prefix draft and that prefix under its own
   head, over a paged pool of 64 blocks with the prefix cache: the paged
   witness's tokens, preemptions, every block back after the drain; (d) rwkv6-1.6b (24 layers, bf16) over the recurrent backend on
   both sides, a 2-layer prefix draft, 8 of phase 10's requests: the
   recurrent witness's tokens, launches with rollback's replayed steps, the
   stash's bytes and the rollbacks' ms a round.  In (a), (c) and (d) each
   kernel of the path is held against its plain version at its shapes;
17. ``serve_fleet`` (after ``serve_spec``, on phase 6's weights): the serving
   fleet (``ServingFleet``), ticked in simulated time: (a) granite-8b at
   full width and depth, bf16, served by a dense replica (H100 profile), a
   paged replica with the prefix cache (iPhone 16), a stage group (H100 +
   iPhone 11 Pro, the cut ``split_decode`` picks) and a spec pair (a
   4-layer prefix drafting on an iPhone 16 profile, k 3), every engine
   prefilling at exact lengths, under ServingElasticPolicy, a throttled
   phone, a seeded crash of the dense replica and a partition that heals
   before detection: 24 requests, half stochastic, all complete; the
   trace's death and resurrections, migrations, no paged block left,
   exact launches, each kernel against its plain version at the fleet's
   shapes, a second seeded run equal, every request never migrated nor
   resurrected bit-equal to an exact-length witness (the others' first
   differing token and its logit margin printed); (b) the reference's fp32
   identity claims (kill fleets over dense, paged and recurrent lanes, a
   migration run, a stage group's rebalance) at full width cut to 4 layers,
   the recurrent kills' launches counted and held to the plain versions;
   (c) (a)'s fleet under wall telemetry: the readings the monitor got
   beside the device time of the same steps, every window closing on an
   idle stream; (d) bench_fleet.py's policies-on/off goodput A/B;
18. ``fed``: the federated serve-while-train plane: FedRoundCoordinators
   over three granite-8b replicas (phase 6's weights) train granite-8b's
   full width cut to 2 layers (fp32, 0.64 B params) after an lr probe:
   int8_ef and bf16 rounds (the wire cut, the held-out loss), bf16
   replays bit-identical, serving tokens identical with training on and
   off, a mid-round crash, a local step's kernels against their plain
   versions and its device time, the frame codec's parts timed; then
   bench_fed.py's own configuration (reduced granite, 6 rounds) from 6
   inits: its loss claim on the mean, its int8_ef replay, its wire cut;
19. ``serve_moe``: llama4-scout-17b-a16e at full width cut to 12 of 48
   layers (57 GB bf16) over dense lanes, max_len 9216, 16 requests, one
   of 9000 tokens (past the 8192 chunk); grok-1-314b at full width cut to
   4 of 64 layers (42.6 GB) over the paged pool; each: exact launches, a
   seeded rerun's tokens equal (lanes share expert capacity at a decode
   step, so no lone-request witness), every kernel and every MoE layer
   (against ``apply_moe_plain``, one routing) held at the served shapes;
20. ``serve_encdec``: whisper-small at full width and depth, 16 requests
   each with its 1500 x 768 frames from ``FrontendPipeline``; 21.
   ``serve_vlm``: internvl2-1b at full width and depth, 16 requests each
   behind 1024 frontend rows; each: exact launches, every request's
   tokens bit-equal to a lone-request witness's, the kernels held at the
   served shapes;
22. ``serve_dense_configs``: mistral-nemo-12b at full width and depth
   (q_dim 4096 != d_model 5120) over bucketed dense lanes and over the
   paged pool: exact launches, the kernels held at the served shapes;
23. ``parity_gspmd``: the GSPMD strategies (``launch/steps.py``,
   ``core/pipeline_gspmd.py``) in fp32 against the port's unsplit step on
   the card: gspmd_tp at grad_accum 2 (reduced whisper-small, reduced
   llama4), gspmd_pp on an emulated (4, 1) mesh (reduced grok-1 and llama4
   at 8 layers, granite-8b's full width at 4 layers), the reduced ones
   also against the CPU; loss, every gradient, exact launches, ``meta``;
24. ``train_gspmd``: whisper-small (full, gspmd_tp, grad_accum 2),
   granite-8b (full width, 8 layers, gspmd_pp over 4 stages) and
   llama4-scout (full width, 1 layer, gspmd_pp over 2 stages, one a pad
   slot) trained in bf16 with remat: a falling loss, exact launches, step
   times, tok/s, MFU, peak memory, a profiled step;
25. ``dryrun``: the analytic dry-run of every arch x shape on both
   production meshes and the H100-mesh roofline (host only).

Each path's launch counts are set to 0 just before it is driven and read
just after: a dense path must launch flash, decode and RMSNorm kernels and
no paged one, a paged path (the agent's too) flash, paged and RMSNorm
kernels and no dense decode one, a stage path exactly the unsplit model's
launches of its prefill dispatches and decode steps, a recurrent serving path exactly its prefill dispatches' and
decode steps' launches (a prefill: the WKV6 or SSD kernel once a layer,
flash once a zamba2 shared-block firing; a decode step: the decode kernel
once a firing and no scan kernel; RMSNorm in both), the rwkv6 training
path the rwkv6 kernel (24 times a forward, twice that under remat), its
backward kernel (24 times a step in bf16) and RMSNorm and no decode
kernel, the zamba2
training path the SSD kernel (42 times a forward, 84 a step), flash (7
and 14) and RMSNorm and no decode kernel, a pipelined training step
exactly each layer's kernels once per forward its (stage, microbatch)
runs and, in bf16, the rwkv6 backward kernel once per (stage, microbatch)
(``pp_launches``) and no decode kernel, a speculative path exactly
its prefills' and its target and draft steps' launches, rollback's
replayed steps included, a fleet exactly the sum over its units of their
prefill dispatches' and steps' launches, the other families' paths
exactly their prefill dispatches' and decode steps' (``family_launches``:
whisper's encoder, decoder and cross-attention flash calls and its two
decode calls a layer).  Each phase's wall time is logged.

The line before the last is a JSON object of per-kernel numbers, the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the checkout beside it, the script exits nonzero and prints no
result.  ``--phases`` runs a subset (default: all); ``--phases
build,baseline --baseline DIR[,DIR...]`` (never run by default) builds the
flash, RMSNorm, dense decode, paged decode, SSD and WKV6 kernels of other
checkouts, e.g. the parent commit unpacked with ``git archive``, and times
them in turns with this one's.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
import zlib
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

PHASES = ("build", "kernels", "parity", "parity_bf16", "parity_train", "serve", "serve_paged",
          "serve_stages", "agent", "serve_spec", "serve_fleet", "fed", "serve_rwkv",
          "serve_hybrid", "serve_moe", "serve_encdec", "serve_vlm", "serve_dense_configs",
          "train", "train_hybrid", "resnet", "train_pp", "parity_gspmd", "train_gspmd", "dryrun")
# the phases that serve full-width granite-8b, one set of weights between them
GRANITE_PHASES = ("serve", "serve_paged", "serve_stages", "agent", "serve_spec", "serve_fleet",
                  "fed")
OPT_IN = ("lr_probe", "baseline")

# the kernels each serving path must launch; the other decode kernel must not
DENSE_PATH = ("flash_attention", "decode_attention", "rmsnorm")
PAGED_PATH = ("flash_attention", "paged_decode_attention", "rmsnorm")
# the kernels each training path must launch; no serving kernel may
RWKV_TRAIN_PATH = ("rwkv6_scan", "rmsnorm")
DENSE_TRAIN_PATH = ("flash_attention", "rmsnorm")
HYBRID_TRAIN_PATH = ("mamba2_ssd", "flash_attention", "rmsnorm")
SERVING_ONLY = ("decode_attention", "paged_decode_attention")
# the recurrent families, served over the recurrent backend
RECURRENT_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
# rwkv6 and SSD kernels vs plain version or recurrence in fp32, and the SSD's
# fp32 final state in a bf16 run: |err| <= SCAN_F32_TOL * max|ref|, the
# reference kernels' own tolerance (tests/test_kernels.py)
SCAN_F32_TOL = 3e-5
# card vs CPU training parity, fp32: loss relative, each gradient leaf
# |err| <= GRAD_TOL * max(1, max|g|), the losses of 3 AdamW steps relative
TRAIN_LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_LOSS_TOL = 1e-4
# calls timed per kernel reading: kernels of tens of microseconds need this
# many to average out the host's jitter (20 calls left (4096, 2048) RMSNorm
# at 0.0164 ms in one run and 0.0253 in the next)
FAST_ITERS = 200
RMS_SHAPES = ((8192, 4096), (8, 4096), (4096, 2048), (4096, 3584), (4096, 7168))
# full-width training lr: the reference launcher's 3e-3 (set for its reduced
# config) raised rwkv6-1.6b's loss over 20 steps; 6e-4 lowers it (PERF.md)
TRAIN_LR = 6e-4


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


def device_ms(fns, iters: int = FAST_ITERS, warmup: int = 3) -> float:
    """Mean device time of the kernels one call launches: torch.profiler's
    kernel records over ``iters`` calls, without the host's dispatch time,
    which bounds ``sync_time_ms`` for kernels of a few microseconds."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def n_sets(bytes_per_set: int, cold_bytes: int = 120 << 20) -> int:
    """Input copies to cycle so one launch's inputs leave the 50 MB L2."""
    return min(8, max(1, -(-cold_bytes // max(1, bytes_per_set))))


def bound(flops: float, flops_peak: float, nbytes: float):
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_path(counts: dict, path: tuple, what: str) -> None:
    """Every kernel of ``path`` launched in this run, and the decode kernel
    of the other layout never did."""
    missed = [k for k in path if counts[k] == 0]
    other = "decode_attention" if path == PAGED_PATH else "paged_decode_attention"
    if missed or counts[other]:
        raise AssertionError(f"{what}: launches {counts}; the path must launch {list(path)} "
                             f"and never {other}")


def check_train_path(counts: dict, path: tuple, what: str) -> None:
    """Every kernel of ``path`` launched in this run, and no serving kernel."""
    missed = [k for k in path if counts[k] == 0]
    if missed or any(counts[k] for k in SERVING_ONLY):
        raise AssertionError(f"{what}: launches {counts}; the path must launch {list(path)} "
                             f"and never {list(SERVING_ONLY)}")


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
        entry = spills = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line:
                spills = line.strip()
            elif "warning" in line.lower() or "(C7" in line:     # ptxas's advisories
                log(f"[build] {name}: {line.strip()[:240]}")
            elif "registers" in line:      # the last line of an entry's report
                log(f"[build] {name}: {entry[:72]}: {line.split(':', 1)[-1].strip()}; "
                    f"{spills}")


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

    # -- rmsnorm: granite-8b's (8192, 4096) prefill-sized and (8, 4096)
    # decode-sized rows, rwkv6-1.6b's training rows (8 x 512, 2048), and
    # zamba2-7b's: the block norms (8 x 512, 3584) and the gated norm (8 x 512, 7168)
    shapes = []
    for rows, d in RMS_SHAPES:
        sets = [(_rand((rows, d), bf, gen), (1 + 0.1 * _rand((d,), torch.float32, gen)).to(bf))
                for _ in range(n_sets(rows * d * 2 * 2))]
        x, s = sets[0]
        err = check_close(f"rmsnorm {rows}x{d} bf16", krms.rmsnorm_cuda(x, s),
                          krms.rmsnorm_plain(x, s), BF16_TOL, relative=True)
        x32, s32 = x.float(), s.float()
        check_close(f"rmsnorm {rows}x{d} f32", krms.rmsnorm_cuda(x32, s32),
                    krms.rmsnorm_plain(x32, s32), F32_TOL, relative=False)
        kern = [lambda a=a, b=b: krms.rmsnorm_cuda(a, b) for a, b in sets]
        lib = [lambda a=a, b=b: F.rms_norm(a, (d,), b, 1e-5) for a, b in sets]
        ms, lib_ms = sync_time_ms(kern, iters=FAST_ITERS), sync_time_ms(lib, iters=FAST_ITERS)
        dev_ms, lib_dev_ms = device_ms(kern), device_ms(lib)
        plain_ms = sync_time_ms([lambda a=a, b=b: krms.rmsnorm_plain(a, b) for a, b in sets])
        b_ms, b_by = bound(4.0 * rows * d, PEAK_F32_FLOPS, rows * d * 2 * 2 + d * 2)
        log(f"[kernels] rmsnorm ({rows},{d}) bf16: max_abs_err {err:.3e}  kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f})  plain {plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms (device "
            f"{lib_dev_ms:.4f})  bound {b_ms:.4f} ms ({b_by})")
        shapes.append(dict(shape=f"x ({rows},{d}) bf16", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                           device_ms=dev_ms, library_device_ms=lib_dev_ms))
    results["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:25", **shapes[0], shapes=shapes[1:])

    # -- flash attention: B=2, H=32, G=8, D=128, causal, T=1024 and ragged
    # 1000, and a serving bucket the engine dispatches, B=8 T=128
    h, g, d = 32, 8, 128
    for b, t in ((2, 1024), (2, 1000), (8, 128)):
        row = flash_case(f"B={b} T={t} H={h} G={g} D={d} causal bf16", b, t, h, g, d, gen)
        if t == 1024:
            results["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:88", **row)
        elif t == 128:
            results["flash_attention"]["serving_bucket"] = row
    flash_d112(results, gen)

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
    mask4 = valid[:, None, None, :]
    kern = [lambda a=a: kdec.decode_attention_cuda(a[0], a[1], a[2], valid, scale) for a in sets]
    lib = [lambda a=a: _sdpa_gqa(a[0], a[1], a[2], attn_mask=mask4) for a in sets]
    ms, lib_ms = sync_time_ms(kern, iters=FAST_ITERS), sync_time_ms(lib, iters=FAST_ITERS)
    dev_ms, lib_dev_ms = device_ms(kern), device_ms(lib)
    plain_ms = sync_time_ms([lambda a=a: kdec.decode_attention_plain(a[0], a[1], a[2], valid,
                                                                     scale) for a in sets])
    live = int(valid.sum().item())                    # positions this data needs read
    b_ms, b_by = bound(4.0 * h * d * live, PEAK_BF16_FLOPS,
                       2 * live * g * d * 2 + 2 * 2 * b * h * d + b * s)
    log(f"[kernels] decode B={b} S={s} H={h} G={g} D={d} bf16 ({live} live positions): "
        f"max_abs_err {err:.3e}  kernel {ms:.4f} ms (device {dev_ms:.4f})  plain "
        f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f})  bound "
        f"{b_ms:.4f} ms ({b_by})")
    # a lane with no valid position: the mean of V over the span, as the TPU
    # kernel's finite mask gives
    empty = valid.clone()
    empty[2] = False
    for dt, tol, rel in ((bf, BF16_TOL, True), (torch.float32, F32_TOL, False)):
        qq, kk, vv = q.to(dt), ck.to(dt), cv.to(dt)
        got = kdec.decode_attention_cuda(qq, kk, vv, empty, scale)
        check_close(f"decode empty lane {dt}", got, kdec.decode_attention_plain(
            qq, kk, vv, empty, scale), tol, relative=rel)
        check_close(f"decode empty lane {dt} = mean of V", got[2, 0],
                    vv[2].float().mean(0).repeat_interleave(h // g, dim=0), tol, relative=rel)
    log(f"[kernels] decode lane with no valid position = mean of V over the span (bf16, f32)")
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:64", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms,
        shape=f"B={b} S={s} H={h} G={g} D={d} bf16, {live} live positions")
    paged_kernel(results, gen)
    decode_floor(results, gen)
    decode_d112(gen)
    rwkv6_kernel(results, gen)
    rwkv6_backward_kernel(results, gen)
    ssd_kernel(results, gen)
    family_kernels(results, gen)


def flash_pairs(t: int, tk: int, causal: bool, chunk: int) -> int:
    """(query, key) pairs a flash call attends: key <= query where causal,
    both in one chunk where chunked."""
    q = np.arange(t)[:, None]
    k = np.arange(tk)[None, :]
    seen = np.ones((t, tk), bool)
    if causal:
        seen &= k <= q
    if chunk:
        seen &= q // chunk == k // chunk
    return int(seen.sum())


def flash_case(shape: str, b: int, t: int, h: int, g: int, d: int,
               gen: torch.Generator, tk: int = 0, causal: bool = True, chunk: int = 0,
               fast_iters: int = FAST_ITERS) -> dict:
    """Flash (causal unless told, ``tk`` keys where it is not T, ``chunk``
    for chunked-local) in bf16 and fp32 against the plain version, then
    kernel, plain and SDPA (with the chunk's mask where chunked) times over
    input sets cycled out of L2; the bound counts q, k and v read and the
    output written once, and the pairs the mask leaves."""
    from repro_torch.kernels import flash_attention as kfa
    tk = tk or t
    kw = dict(causal=causal, chunk=chunk)
    io_bytes = 2 * (2 * b * t * h * d + 2 * b * tk * g * d)
    sets = [(_rand((b, t, h, d), torch.bfloat16, gen), _rand((b, tk, g, d), torch.bfloat16, gen),
             _rand((b, tk, g, d), torch.bfloat16, gen)) for _ in range(n_sets(io_bytes))]
    q, k, v = sets[0]
    err = check_close(f"flash {shape}", kfa.flash_attention_cuda(q, k, v, **kw),
                      kfa.flash_attention_plain(q, k, v, **kw), BF16_TOL, relative=True)
    q32, k32, v32 = q.float(), k.float(), v.float()
    check_close(f"flash {shape} f32", kfa.flash_attention_cuda(q32, k32, v32, **kw),
                kfa.flash_attention_plain(q32, k32, v32, **kw), F32_TOL, relative=False)
    if chunk:
        qp, kp = torch.arange(t, device="cuda")[:, None], torch.arange(tk, device="cuda")[None]
        mask = (kp <= qp) & (qp // chunk == kp // chunk)
        sdpa_kw = dict(attn_mask=mask)
    else:
        sdpa_kw = dict(is_causal=causal)
    kern = [lambda a=a: kfa.flash_attention_cuda(*a, **kw) for a in sets]
    lib = [lambda a=a: _sdpa_gqa(*a, **sdpa_kw) for a in sets]
    ms, lib_ms = sync_time_ms(kern, iters=fast_iters), sync_time_ms(lib, iters=fast_iters)
    dev_ms, lib_dev_ms = device_ms(kern, iters=fast_iters), device_ms(lib, iters=fast_iters)
    plain_ms = sync_time_ms([lambda a=a: kfa.flash_attention_plain(*a, **kw) for a in sets],
                            iters=5, warmup=1)
    b_ms, b_by = bound(4.0 * b * h * d * flash_pairs(t, tk, causal, chunk), PEAK_BF16_FLOPS,
                       io_bytes)
    log(f"[kernels] flash {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f})  "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms)


def flash_d112(results: dict, gen: torch.Generator) -> None:
    """Flash at zamba2-7b's shared block: B 8, T 512, 32 heads over 32 KV
    heads of 112, causal."""
    results["flash_attention"]["zamba2_shape"] = flash_case(
        "B=8 T=512 H=32 G=32 D=112 causal bf16 (zamba2's shared block)", 8, 512, 32, 32, 112,
        gen)


def ssd_flops(b: int, t: int, h: int, p: int, n: int, c: int = 64) -> float:
    """fp32 operations the chunked SSD needs (chunk ``c``), a multiply-add
    counted as 2, exponentials left out: per chunk and (batch, head) the
    inter term C S0^T (2cNP) and its decay scale (cP), the scores C.B^T of
    the c(c+1)/2 pairs s <= t (2N each) and their decay and dt scales (2
    each), G x over those pairs (2P each), D x (2cP), the state update
    (2cPN, its e^{la_c} scale PN) and the update weights (cP)."""
    pairs = c * (c + 1) // 2
    per_chunk = (2 * c * n * p + c * p + pairs * (2 * n + 2) + pairs * 2 * p + 2 * c * p
                 + 2 * c * p * n + p * n + c * p)
    return float(b * h * -(-t // c) * per_chunk)


SSD_SHAPE = (8, 512, 112, 64, 64)      # zamba2-7b's training step: B, T, H, P, N
SSD_BYTES = (2 * 8 * 512 * 112 * 64 * 2 + 2 * 8 * 512 * 64 * 2 + 8 * 512 * 112 * 4
             + 2 * 112 * 4 + 8 * 112 * 64 * 64 * 4)   # x, y; B, C; dt; A, D; fp32 state


def ssd_inputs(gen: torch.Generator, dtype, t: int = SSD_SHAPE[1], decay: str = "model"):
    """x, dt, A, B, C, D at zamba2-7b's training widths, x, B and C cut from
    one (B, T, 7296) conv output as the model cuts them (strided views).
    ``decay``: "model" (dt = softplus(N(0,1) + dt_bias), A = -linspace(1,
    16), as the model's init draws them), "reference" (tests/test_kernels.py:
    dt = softplus(N(0,1)), A = -exp(0.3 N)) or "strong" (dt uniform in [0,
    5], A = -16)."""
    b, _, h, p, n = SSD_SHAPE
    d_in = h * p
    xbc = _rand((b, t, d_in + 2 * n), dtype, gen)
    x = xbc[..., :d_in].reshape(b, t, h, p)
    bm, cm = xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    z = _rand((b, t, h), torch.float32, gen)
    if decay == "model":
        dt = F.softplus(z + float(np.log(np.expm1(0.01))))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    elif decay == "reference":
        dt = F.softplus(z)
        a = -torch.exp(0.3 * _rand((h,), torch.float32, gen))
    else:
        dt = 5.0 * torch.rand((b, t, h), generator=gen, device="cuda")
        a = torch.full((h,), -16.0, device="cuda")
    return x, dt, a, bm, cm, 1.0 + 0.1 * _rand((h,), torch.float32, gen)


def gate(got: torch.Tensor, ref: torch.Tensor, tol: float, elementwise: bool) -> float:
    """A gate's margin, max |err| / limit (<= 1 passes): ``elementwise``
    tol x max(1, |ref|) per element (the bf16 gates), else tol x max|ref|
    (the scans' 3e-5 gates)."""
    err = (got.float() - ref.float()).abs()
    if elementwise:
        return (err / (tol * ref.float().abs().clamp_min(1.0))).max().item()
    return err.max().item() / (tol * ref.float().abs().max().item())


def check_gates(name: str, margins: dict) -> str:
    """Raise if any margin exceeds 1; the margins as one line of text."""
    bad = {k: v for k, v in margins.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"{name}: gates exceeded (error / limit): {bad}")
    return ", ".join(f"{k} {v:.3f}" for k, v in margins.items())


def ssd_kernel(results: dict, gen: torch.Generator) -> None:
    """The SSD kernel at zamba2-7b's training shape (``ssd_inputs``): bf16
    (the tensor-core body) against the plain chunked version, y within
    BF16_TOL x max(1, |ref|) and the fp32 final state within SCAN_F32_TOL x
    max|ref|, and under strong decay at a ragged T of 500 against the token
    recurrence of the same bf16 values; fp32 (the scalar body) against the
    token recurrence at the reference's decay and under strong decay.  Each
    gate's margin (error / limit) is printed."""
    from repro_torch.kernels import mamba2_ssd as kssd
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import mamba2_scan_plain
    b, t, h, p, n = SSD_SHAPE
    sets = [ssd_inputs(gen, torch.bfloat16) for _ in range(n_sets(SSD_BYTES))]
    args = sets[0]
    y, s = kssd.mamba2_ssd_cuda(*args)
    ry, rs = kssd.mamba2_ssd_chunked_plain(*args)
    err = check_close("ssd bf16 y", y, ry, BF16_TOL, relative=True)
    m16 = {"bf16 y": gate(y, ry, BF16_TOL, True), "bf16 state": gate(s, rs, SCAN_F32_TOL, False)}
    strong = ssd_inputs(gen, torch.bfloat16, t=500, decay="strong")
    y, s = kssd.mamba2_ssd_cuda(*strong)
    qy, qs = mamba2_scan_plain(*(a.float() for a in strong))
    m16["bf16 strong T=500 y vs recurrence"] = gate(y, qy, BF16_TOL, True)
    m16["bf16 strong T=500 state vs recurrence"] = gate(s, qs, SCAN_F32_TOL, False)
    del strong, y, s, ry, rs, qy, qs
    m32 = {}
    for what, tt in (("reference", t), ("strong", 500)):
        a32 = ssd_inputs(gen, torch.float32, t=tt, decay=what)
        y, s = kssd.mamba2_ssd_cuda(*a32)
        ry, rs = mamba2_scan_plain(*a32)
        m32[f"f32 {what} T={tt} y vs recurrence"] = gate(y, ry, SCAN_F32_TOL, False)
        m32[f"f32 {what} T={tt} state vs recurrence"] = gate(s, rs, SCAN_F32_TOL, False)
        del a32, y, s, ry, rs
    margins = check_gates("ssd", {**m16, **m32})
    kern = [lambda a=a: kssd.mamba2_ssd_cuda(*a) for a in sets]
    ms, dev_ms = sync_time_ms(kern, iters=FAST_ITERS), device_ms(kern)
    plain_ms = sync_time_ms([lambda a=a: kssd.mamba2_ssd_chunked_plain(*a) for a in sets], iters=5)
    # the autograd backward (autograd through the plain version, recomputed)
    # of ops.mamba2_ssd at the training step's shape, bf16 like the model
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    out, _ = ops.mamba2_ssd(*xs)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, xs, g, retain_graph=True)
    if any(x is None or not torch.isfinite(x.float()).all() for x in grads):
        raise AssertionError("ssd backward: a missing or non-finite gradient")
    bwd_ms = sync_time_ms([lambda: torch.autograd.grad(out, xs, g, retain_graph=True)],
                          iters=5, warmup=1)
    del out, grads, xs
    flops = ssd_flops(b, t, h, p, n)
    b_ms, b_by = bound(flops, PEAK_BF16_FLOPS, SSD_BYTES)
    f32_ms, f32_by = bound(flops, PEAK_F32_FLOPS, SSD_BYTES)
    log(f"[kernels] ssd B={b} T={t} H={h} P={p} N={n} bf16 (strided x, B, C): max_abs_err "
        f"{err:.3e}; gate margins (error / limit; bf16: the tensor-core body, f32: the scalar "
        f"body): {margins}; kernel {ms:.4f} ms (device {dev_ms:.4f})  plain {plain_ms:.4f} ms  "
        f"backward (autograd through the plain version) {bwd_ms:.4f} ms  bound on tensor cores "
        f"{b_ms:.4f} ms ({b_by}), as fp32 vector work {f32_ms:.4f} ms ({f32_by}; "
        f"{flops / 1e9:.2f} GFLOP, {SSD_BYTES / 1e6:.1f} MB)")
    results["mamba2_ssd"] = dict(
        name="mamba2_ssd", route="cuda", source="src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        replaces="src/repro/kernels/mamba2_ssd.py:71", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call computes the SSD scan", device_ms=dev_ms,
        bound_fp32_vector_ms=f32_ms, backward_ms=bwd_ms,
        shape=f"B={b} T={t} H={h} P={p} N={n} bf16, dt and A as the model's init")


def paged_tables(rng: np.random.Generator, pos: np.ndarray, bs: int, max_blocks: int,
                 n_shared: int, shared_lanes: int):
    """Block tables over a pool whose blocks are a random permutation: lane
    b holds pos[b] // bs + 1 blocks, the first ``n_shared`` of lanes
    0..shared_lanes-1 are the same blocks (a shared prompt prefix), entries
    past a lane's blocks are the sink (0).  Returns (tables, pool blocks)."""
    need = pos // bs + 1
    n_pool = 1 + int(need.sum()) - sum(min(n_shared, int(need[lane]))
                                       for lane in range(1, shared_lanes))
    perm = iter(rng.permutation(np.arange(1, n_pool)))
    tables = np.zeros((len(pos), max_blocks), np.int32)
    for lane, n in enumerate(need):
        for i in range(n):
            tables[lane, i] = tables[0, i] if (0 < lane < shared_lanes and i < n_shared) \
                else next(perm)
    return tables, n_pool


def paged_kernel(results: dict, gen: torch.Generator) -> None:
    """The paged kernel at the full-width decode shape: 16 lanes, bs 16,
    H 32 over G 8, D 128, bf16, ragged pos of 16-1023, tables a random
    permutation of pool blocks with a 64-token prefix shared by 8 lanes."""
    from repro_torch.kernels import paged_attention as kpaged
    bf = torch.bfloat16
    b, h, g, d, bs, max_blocks = 16, 32, 8, 128, 16, 64
    rng = np.random.default_rng(0)
    pos = rng.integers(16, 1024, size=b)
    pos[0], pos[1] = 1023, 16                       # a full table and a short lane
    tables, n_pool = paged_tables(rng, pos, bs, max_blocks, n_shared=4, shared_lanes=8)
    bt = torch.as_tensor(tables, device="cuda")
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    pool_bytes = 2 * n_pool * bs * g * d * 2
    sets = [(_rand((b, 1, h, d), bf, gen), _rand((n_pool, bs, g, d), bf, gen),
             _rand((n_pool, bs, g, d), bf, gen)) for _ in range(n_sets(pool_bytes))]
    q, kp, vp = sets[0]
    err = check_close("paged bf16", kpaged.paged_decode_attention_cuda(q, kp, vp, bt, pos_t,
                                                                       scale),
                      kpaged.paged_decode_attention_plain(q, kp, vp, bt, pos_t, scale),
                      BF16_TOL, relative=True)
    # fp32 at a small shape: 3 lanes, bs 8, two lanes sharing a block
    pos32 = np.array([30, 9, 0])
    t32, n32 = paged_tables(rng, pos32, 8, 5, n_shared=1, shared_lanes=2)
    args32 = (_rand((3, 1, 8, 64), torch.float32, gen), _rand((n32, 8, 2, 64), torch.float32, gen),
              _rand((n32, 8, 2, 64), torch.float32, gen), torch.as_tensor(t32, device="cuda"),
              torch.as_tensor(pos32, dtype=torch.int32, device="cuda"))
    check_close("paged f32", kpaged.paged_decode_attention_cuda(*args32, 0.125),
                kpaged.paged_decode_attention_plain(*args32, 0.125), F32_TOL, relative=False)
    kern = [lambda a=a: kpaged.paged_decode_attention_cuda(a[0], a[1], a[2], bt, pos_t, scale)
            for a in sets]
    ms, dev_ms = sync_time_ms(kern, iters=FAST_ITERS), device_ms(kern)
    plain_ms = sync_time_ms([lambda a=a: kpaged.paged_decode_attention_plain(
        a[0], a[1], a[2], bt, pos_t, scale) for a in sets])
    span = max_blocks * bs
    idx = bt.long()
    mask4 = (torch.arange(span, device="cuda")[None, :] <= pos_t[:, None].long())[:, None, None]

    def gather_sdpa(a):
        ck = a[1][idx].reshape(b, span, g, d)
        cv = a[2][idx].reshape(b, span, g, d)
        return _sdpa_gqa(a[0], ck, cv, attn_mask=mask4).transpose(1, 2)
    check_close("gather + SDPA vs paged plain", gather_sdpa(sets[0]),
                kpaged.paged_decode_attention_plain(q, kp, vp, bt, pos_t, scale), BF16_TOL,
                relative=True)
    lib = [lambda a=a: gather_sdpa(a) for a in sets]
    lib_ms, lib_dev_ms = sync_time_ms(lib, iters=FAST_ITERS), device_ms(lib)
    # bytes: each live pool row (K and V) read once -- a shared block once --
    # plus q, out, tables, pos; operations: every lane's own live positions
    live_rows = {int(tables[lane, p // bs]) * bs + p % bs
                 for lane in range(b) for p in range(pos[lane] + 1)}
    n_live = int((pos + 1).sum())
    b_ms, b_by = bound(4.0 * h * d * n_live, PEAK_BF16_FLOPS,
                       2 * len(live_rows) * g * d * 2 + 2 * 2 * b * h * d + tables.nbytes
                       + 4 * b)
    log(f"[kernels] paged B={b} bs={bs} max_blocks={max_blocks} H={h} G={g} D={d} bf16 "
        f"({n_live} live positions, {len(live_rows)} distinct pool rows, pool {n_pool} blocks): "
        f"max_abs_err {err:.3e}  kernel {ms:.4f} ms (device {dev_ms:.4f})  plain "
        f"{plain_ms:.4f} ms  gather+sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f})  bound "
        f"{b_ms:.4f} ms ({b_by})")
    results["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:67", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms,
        library="kp/vp[block_tables] gathers + SDPA (enable_gqa): two calls, no single "
                "PyTorch call computes the function",
        shape=f"B={b} bs={bs} max_blocks={max_blocks} H={h} G={g} D={d} bf16, {n_live} live "
              f"positions")


# the other families' shapes on their paths' kernels: (what, B, T, Tk, H, G, D,
# causal, chunk) for flash, one request's prefill as the engine dispatches it
FAMILY_FLASH = (
    ("whisper-small encoder", 1, 1500, 1500, 12, 12, 64, False, 0),
    ("whisper-small cross-attention, a 64-token prompt", 1, 64, 1500, 12, 12, 64, False, 0),
    ("internvl2-1b, 1024 rows + 64 tokens", 1, 1088, 1088, 14, 2, 64, True, 0),
    # whisper-small's gspmd_tp training microbatch (8 x 448 at grad_accum 2, GSPMD_RUNS)
    ("whisper-small training encoder", 4, 1500, 1500, 12, 12, 64, False, 0),
    ("whisper-small training decoder self-attention", 4, 448, 448, 12, 12, 64, True, 0),
    ("whisper-small training cross-attention", 4, 448, 1500, 12, 12, 64, False, 0),
    ("llama4-scout chunked-local 8192, 9000 tokens", 1, 9000, 9000, 40, 8, 128, True, 8192),
    ("grok-1, 600 tokens", 1, 600, 600, 48, 8, 128, True, 0),
)
# (what, B, S, H, G, D, every position valid) for the dense decode kernel
FAMILY_DECODE = (
    ("llama4-scout ring lanes", 8, 8192, 40, 8, 128, False),
    ("whisper-small self-attention", 8, 448, 12, 12, 64, False),
    ("whisper-small cross-attention", 8, 1500, 12, 12, 64, True),
    ("internvl2-1b", 8, 1536, 14, 2, 64, False),
    ("mistral-nemo-12b", 8, 1024, 32, 8, 128, False),
)
# (what, B, H, G) for the paged kernel at bs 16, 64 blocks a lane
FAMILY_PAGED = (("grok-1", 16, 48, 8), ("mistral-nemo-12b", 16, 32, 8))
# (what, rows, d_model) for RMSNorm: a prefill's rows and a decode step's
FAMILY_RMS = (("whisper-small", 1500, 768), ("internvl2-1b", 1088, 896),
              ("llama4-scout / mistral-nemo", 9000, 5120), ("grok-1", 600, 6144),
              ("grok-1 decode", 16, 6144))


def family_kernels(results: dict, gen: torch.Generator) -> None:
    """Flash, both decode kernels and RMSNorm at the shapes the other
    families' paths give them (the tables above), each against its plain
    version (bf16 within BF16_TOL x max(1, |ref|), flash also in fp32), and
    timed beside its plain version, its bound and the PyTorch call where
    one computes it (SDPA, with the chunk mask or the valid mask;
    ``F.rms_norm``).  The rows go under each kernel's ``family_shapes``."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_attention as kpaged
    from repro_torch.kernels import rmsnorm as krms
    bf = torch.bfloat16
    rows = results["flash_attention"].setdefault("family_shapes", [])
    for what, b, t, tk, h, g, d, causal, chunk in FAMILY_FLASH:
        shape = (f"{what}: B={b} T={t} Tk={tk} H={h} G={g} D={d} "
                 f"{'chunk ' + str(chunk) if chunk else 'causal' if causal else 'full'} bf16")
        rows.append(flash_case(shape, b, t, h, g, d, gen, tk=tk, causal=causal, chunk=chunk,
                               fast_iters=20 if t * tk > 4e6 else FAST_ITERS))
    rows = results["decode_attention"].setdefault("family_shapes", [])
    for what, b, s, h, g, d, full in FAMILY_DECODE:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        lens[0] = s
        valid = torch.arange(s, device="cuda")[None, :] < (s if full else lens[:, None])
        valid = valid.expand(b, s).contiguous()
        scale = d ** -0.5
        sets = [(_rand((b, 1, h, d), bf, gen), _rand((b, s, g, d), bf, gen),
                 _rand((b, s, g, d), bf, gen)) for _ in range(n_sets(2 * b * s * g * d * 2))]
        q, ck, cv = sets[0]
        err = check_close(f"decode {what}", kdec.decode_attention_cuda(q, ck, cv, valid, scale),
                          kdec.decode_attention_plain(q, ck, cv, valid, scale), BF16_TOL,
                          relative=True)
        mask4 = valid[:, None, None, :]
        kern = [lambda a=a: kdec.decode_attention_cuda(*a, valid, scale) for a in sets]
        lib = [lambda a=a: _sdpa_gqa(*a, attn_mask=mask4) for a in sets]
        ms, lib_ms = sync_time_ms(kern, iters=FAST_ITERS), sync_time_ms(lib, iters=FAST_ITERS)
        dev_ms, lib_dev_ms = device_ms(kern), device_ms(lib)
        plain_ms = sync_time_ms([lambda a=a: kdec.decode_attention_plain(*a, valid, scale)
                                 for a in sets])
        live = int(valid.sum().item())
        b_ms, b_by = bound(4.0 * h * d * live, PEAK_BF16_FLOPS,
                           2 * live * g * d * 2 + 2 * 2 * b * h * d + b * s)
        shape = f"{what}: B={b} S={s} H={h} G={g} D={d} bf16, {live} live positions"
        log(f"[kernels] decode {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (device "
            f"{lib_dev_ms:.4f})  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev_ms))
    rows = results["paged_decode_attention"].setdefault("family_shapes", [])
    rng = np.random.default_rng(1)
    for what, b, h, g in FAMILY_PAGED:
        d, bs, max_blocks, scale = 128, 16, 64, 128 ** -0.5
        pos = rng.integers(16, max_blocks * bs, size=b)
        tables, n_pool = paged_tables(rng, pos, bs, max_blocks, n_shared=0, shared_lanes=0)
        bt = torch.as_tensor(tables, device="cuda")
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        sets = [(_rand((b, 1, h, d), bf, gen), _rand((n_pool, bs, g, d), bf, gen),
                 _rand((n_pool, bs, g, d), bf, gen))
                for _ in range(n_sets(2 * n_pool * bs * g * d * 2))]
        q, kp, vp = sets[0]
        err = check_close(f"paged {what}", kpaged.paged_decode_attention_cuda(
            q, kp, vp, bt, pos_t, scale), kpaged.paged_decode_attention_plain(
            q, kp, vp, bt, pos_t, scale), BF16_TOL, relative=True)
        kern = [lambda a=a: kpaged.paged_decode_attention_cuda(*a, bt, pos_t, scale)
                for a in sets]
        ms, dev_ms = sync_time_ms(kern, iters=FAST_ITERS), device_ms(kern)
        plain_ms = sync_time_ms([lambda a=a: kpaged.paged_decode_attention_plain(
            *a, bt, pos_t, scale) for a in sets])
        n_live = int((pos + 1).sum())
        b_ms, b_by = bound(4.0 * h * d * n_live, PEAK_BF16_FLOPS,
                           2 * n_live * g * d * 2 + 2 * 2 * b * h * d + tables.nbytes + 4 * b)
        shape = (f"{what}: B={b} bs={bs} max_blocks={max_blocks} H={h} G={g} D={d} bf16, "
                 f"{n_live} live positions")
        log(f"[kernels] paged {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, device_ms=dev_ms))
    rows = results["rmsnorm"].setdefault("family_shapes", [])
    for what, n, d in FAMILY_RMS:
        sets = [(_rand((n, d), bf, gen), (1 + 0.1 * _rand((d,), torch.float32, gen)).to(bf))
                for _ in range(n_sets(n * d * 2 * 2))]
        x, sc = sets[0]
        err = check_close(f"rmsnorm {what}", krms.rmsnorm_cuda(x, sc), krms.rmsnorm_plain(x, sc),
                          BF16_TOL, relative=True)
        kern = [lambda a=a: krms.rmsnorm_cuda(*a) for a in sets]
        lib = [lambda a=a: F.rms_norm(a[0], (d,), a[1], 1e-5) for a in sets]
        ms, lib_ms = sync_time_ms(kern, iters=FAST_ITERS), sync_time_ms(lib, iters=FAST_ITERS)
        dev_ms, lib_dev_ms = device_ms(kern), device_ms(lib)
        plain_ms = sync_time_ms([lambda a=a: krms.rmsnorm_plain(*a) for a in sets])
        b_ms, b_by = bound(4.0 * n * d, PEAK_F32_FLOPS, n * d * 2 * 2 + d * 2)
        shape = f"{what}: x ({n},{d}) bf16"
        log(f"[kernels] rmsnorm {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  F.rms_norm {lib_ms:.4f} ms (device "
            f"{lib_dev_ms:.4f})  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev_ms))


def decode_floor(results: dict, gen: torch.Generator) -> None:
    """Each decode kernel's device time at its phase-3 geometry with one live
    position a lane (the launch, layout reads and merge alone) and with
    every position live (the streaming rate, against the bytes bound)."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_attention as kpaged
    bf, h, g, d, scale = torch.bfloat16, 32, 8, 128, 128 ** -0.5
    b, s = 8, 1024
    sets = [tuple(_rand((b, n, m, d), bf, gen) for n, m in ((1, h), (s, g), (s, g)))
            for _ in range(n_sets(2 * b * s * g * d * 2))]
    pb, bs, max_blocks = 16, 16, 64
    n_pool = 1 + pb * max_blocks
    tables = torch.arange(1, n_pool, dtype=torch.int32, device="cuda").reshape(pb, max_blocks)
    psets = [tuple(_rand(shape, bf, gen) for shape in ((pb, 1, h, d), (n_pool, bs, g, d),
                                                       (n_pool, bs, g, d)))
             for _ in range(n_sets(2 * n_pool * bs * g * d * 2))]
    for name, live in (("dense_1_live", 1), ("dense_all_live", s)):
        valid = (torch.arange(s, device="cuda") < live).expand(b, s).contiguous()
        t = device_ms([lambda a=a: kdec.decode_attention_cuda(*a, valid, scale) for a in sets])
        b_ms, _ = bound(0.0, PEAK_BF16_FLOPS, 2 * b * live * g * d * 2)
        results["decode_attention"][f"device_ms_{name[6:]}"] = t
        log(f"[kernels] decode B={b} S={s} H={h} G={g} D={d} bf16, {live} live position(s) a "
            f"lane: device {t:.4f} ms, bytes bound {b_ms:.4f} ms")
    for name, p in (("1_live", 0), ("all_live", max_blocks * bs - 1)):
        pos = torch.full((pb,), p, dtype=torch.int32, device="cuda")
        t = device_ms([lambda a=a: kpaged.paged_decode_attention_cuda(*a, tables, pos, scale)
                       for a in psets])
        b_ms, _ = bound(0.0, PEAK_BF16_FLOPS, 2 * pb * (p + 1) * g * d * 2)
        results["paged_decode_attention"][f"device_ms_{name}"] = t
        log(f"[kernels] paged B={pb} bs={bs} max_blocks={max_blocks} H={h} G={g} D={d} bf16, "
            f"{p + 1} live position(s) a lane: device {t:.4f} ms, bytes bound {b_ms:.4f} ms")


def decode_d112(gen: torch.Generator) -> None:
    """Both decode kernels at head_dim 112, bf16 and fp32, against their
    plain versions: zamba2-7b's shared block (32 query heads over 32 KV
    heads) and a GQA geometry (32 over 8); 8 lanes of a 512-position span,
    ragged, lane 0 full and lane 1 with no live position (the mean of V)."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_attention as kpaged
    rng = np.random.default_rng(1)
    b, d, bs, max_blocks = 8, 112, 16, 32
    span = bs * max_blocks
    for h, g in ((32, 32), (32, 8)):
        pos = rng.integers(0, span, size=b)
        pos[0], pos[1] = span - 1, -1
        tables, n_pool = paged_tables(rng, pos, bs, max_blocks, n_shared=2, shared_lanes=4)
        bt = torch.as_tensor(tables, device="cuda")
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        valid = torch.arange(span, device="cuda")[None, :] <= pos_t[:, None]
        for dt, tol, rel in ((torch.bfloat16, BF16_TOL, True), (torch.float32, F32_TOL, False)):
            q = _rand((b, 1, h, d), dt, gen)
            ck, cv = _rand((b, span, g, d), dt, gen), _rand((b, span, g, d), dt, gen)
            check_close(f"decode D=112 H={h} G={g} {dt}",
                        kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5),
                        kdec.decode_attention_plain(q, ck, cv, valid, d ** -0.5), tol, rel)
            kp, vp = _rand((n_pool, bs, g, d), dt, gen), _rand((n_pool, bs, g, d), dt, gen)
            check_close(f"paged D=112 H={h} G={g} {dt}",
                        kpaged.paged_decode_attention_cuda(q, kp, vp, bt, pos_t, d ** -0.5),
                        kpaged.paged_decode_attention_plain(q, kp, vp, bt, pos_t, d ** -0.5),
                        tol, rel)
    log(f"[kernels] decode and paged at head_dim 112 (H=32 over G=32 and G=8, bf16 and f32, "
        f"a lane with no live position) agree with their plain versions")


def rwkv6_flops(b: int, t: int, h: int, dk: int, c: int = 16) -> float:
    """Operations of the chunked WKV6 recurrence at chunk ``c`` (16, the
    fewest of the port's chunkings; the bf16 body's 64 forms more pairs),
    counting a multiply-add as 2 and leaving out the exponentials: per chunk and
    (batch, head) the inter term r e^{La} S (2cK^2), the scores of the
    c(c-1)/2 pairs s < t (3K each) and the bonus diagonal (3cK), P v over
    the c(c+1)/2 pairs (2K each), the decay weights (2cK) and the state
    update (2cK^2 + K^2)."""
    per_chunk = (4 * c * dk * dk + dk * dk + 3 * c * (c - 1) // 2 * dk + 3 * c * dk
                 + c * (c + 1) * dk + 2 * c * dk)
    return float(b * h * -(-t // c) * per_chunk)


RWKV_SHAPE = (8, 512, 32, 64)            # rwkv6-1.6b's training step: B, T, H, K
RWKV_BYTES = 4 * 8 * 512 * 32 * 64 * 2 + 8 * 512 * 32 * 64 * 4 + 32 * 64 * 4  # r k v out; lw; u


def rwkv6_inputs(gen: torch.Generator, dtype, lw=None):
    """r, k, v, log-decay, u at rwkv6-1.6b's training shape; the log-decay
    drawn like the model's at init (-exp(w0 + LoRA), w0 = -4, the LoRA term
    ~N(0, 0.8)) unless given."""
    shape = RWKV_SHAPE
    r, k, v = (_rand(shape, dtype, gen) for _ in range(3))
    if lw is None:
        lw = -torch.exp(-4.0 + 0.8 * _rand(shape, torch.float32, gen))
    return r, k, v, lw, 0.3 * _rand(shape[2:], torch.float32, gen)


def rwkv6_kernel(results: dict, gen: torch.Generator) -> None:
    """The rwkv6 kernel at rwkv6-1.6b's training shape (``rwkv6_inputs``):
    bf16 (the tensor-core body) against the plain chunked version and, under
    strong decay (per-step log-decay down to -5), against the token
    recurrence of the same bf16 values, within BF16_TOL x max(1, |ref|);
    fp32 (the scalar body) against the plain version and under strong decay
    against the recurrence, within SCAN_F32_TOL x max|ref|.  Each gate's
    margin (error / limit) is printed."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as krwkv
    from repro_torch.models.rwkv import rwkv6_scan_plain
    bf = torch.bfloat16
    b, t, h, dk = RWKV_SHAPE
    sets = [rwkv6_inputs(gen, bf) for _ in range(n_sets(RWKV_BYTES))]
    args = sets[0]
    got, ref = krwkv.rwkv6_cuda(*args), krwkv.rwkv6_chunked_plain(*args)
    err = check_close("rwkv6 bf16", got, ref, BF16_TOL, relative=True)
    margins = {"bf16 out": gate(got, ref, BF16_TOL, True)}

    def strong(dtype):
        return rwkv6_inputs(gen, dtype, lw=-5.0 * torch.rand(RWKV_SHAPE, generator=gen,
                                                             device="cuda"))
    sb = strong(bf)
    rec, _ = rwkv6_scan_plain(*(a.float() for a in sb[:3]), torch.exp(sb[3]), sb[4])
    margins["bf16 strong decay vs recurrence"] = gate(krwkv.rwkv6_cuda(*sb), rec, BF16_TOL, True)
    a32 = [a.float() for a in args]
    margins["f32 out"] = gate(krwkv.rwkv6_cuda(*a32), krwkv.rwkv6_chunked_plain(*a32),
                              SCAN_F32_TOL, False)
    s32 = strong(torch.float32)
    rec, _ = rwkv6_scan_plain(*s32[:3], torch.exp(s32[3]), s32[4])
    margins["f32 strong decay vs recurrence"] = gate(krwkv.rwkv6_cuda(*s32), rec, SCAN_F32_TOL,
                                                     False)
    del sb, a32, s32, rec, got, ref
    margins = check_gates("rwkv6", margins)
    kern = [lambda a=a: krwkv.rwkv6_cuda(*a) for a in sets]
    ms, dev_ms = sync_time_ms(kern, iters=FAST_ITERS), device_ms(kern)
    plain_ms = sync_time_ms([lambda a=a: krwkv.rwkv6_chunked_plain(*a) for a in sets], iters=5)
    # the autograd backward of ops.rwkv6_scan at the training step's shape,
    # bf16 like the model (the backward kernel, then the log-decay's own)
    r, k, v, lw, u = (x.detach().clone().requires_grad_(True) for x in args)
    w = torch.exp(lw)
    out = ops.rwkv6_scan(r, k, v, w, u)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (r, k, v, w, u), g, retain_graph=True)
    if any(x is None or not torch.isfinite(x.float()).all() for x in grads):
        raise AssertionError("rwkv6 backward: a missing or non-finite gradient")
    bwd_ms = sync_time_ms([lambda: torch.autograd.grad(out, (r, k, v, w, u), g,
                                                       retain_graph=True)], iters=5, warmup=1)
    del out, grads
    flops = rwkv6_flops(b, t, h, dk)
    b_ms, b_by = bound(flops, PEAK_BF16_FLOPS, RWKV_BYTES)
    f32_ms, f32_by = bound(flops, PEAK_F32_FLOPS, RWKV_BYTES)
    log(f"[kernels] rwkv6 B={b} T={t} H={h} K={dk} bf16: max_abs_err {err:.3e}; gate margins "
        f"(error / limit; bf16: the tensor-core body, f32: the scalar body): {margins}; kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f})  plain {plain_ms:.4f} ms  backward (ops.rwkv6_scan "
        f"under autograd) {bwd_ms:.4f} ms  bound on tensor cores {b_ms:.4f} ms "
        f"({b_by}), as fp32 vector work {f32_ms:.4f} ms ({f32_by}; {flops / 1e9:.2f} GFLOP, "
        f"{RWKV_BYTES / 1e6:.1f} MB)")
    results["rwkv6_scan"] = dict(
        name="rwkv6_scan", route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:71", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library="none: no single PyTorch call computes the WKV6 recurrence", device_ms=dev_ms,
        bound_fp32_vector_ms=f32_ms, backward_ms=bwd_ms,
        shape=f"B={b} T={t} H={h} K={dk} bf16, log-decay -exp(-4 + 0.8 N)")


RWKV_BWD_SHAPES = ((8, 1024, 32, 64),      # the benchmark's rwkv6-1.6b.train cell
                   (8, 512, 32, 64))       # the train phase


def rwkv6_bwd_flops(b: int, t: int, h: int, dk: int, c: int = 16) -> float:
    """Operations of the chunked WKV6 backward at the kernel's chunk ``c``,
    a multiply-add as 2, the exponentials left out: per chunk and (batch,
    head) five K x c x K products (S0 g, Gc v, Gc^T kd, the update of G and
    the forward walk's of S: 10cK^2), A and P over the pairs s <= t (2K and
    3K a pair), dr's and dk's pair sums (3K each a pair s < t) and P g (2K
    a pair s <= t)."""
    pairs, below = c * (c + 1) // 2, c * (c - 1) // 2
    per_chunk = 10 * c * dk * dk + pairs * 4 * dk + below * 9 * dk
    return float(b * h * -(-t // c) * per_chunk)


def rwkv6_bwd_bytes(b: int, t: int, h: int, dk: int) -> int:
    """Bytes the backward reads and writes once: r, k, v, g in and dr, dk, dv
    out in bf16, the log-decay in and its gradient out in fp32, u and du."""
    n = b * t * h * dk
    return 7 * n * 2 + 2 * n * 4 + 2 * h * dk * 4


def _wkv6_plain_vjp(r, k, v, lw, u, g):
    """(dr, dk, dv, dlog_w, du) by autograd through the plain chunked
    version, the bf16 path's backward before its kernel."""
    from repro_torch.kernels import rwkv6_scan as krwkv
    with torch.enable_grad():
        xs = [a.detach().clone().requires_grad_(True) for a in (r, k, v, lw, u)]
        return torch.autograd.grad(krwkv.rwkv6_chunked_plain(*xs), xs, g)


def rwkv6_backward_kernel(results: dict, gen: torch.Generator) -> None:
    """The WKV6 backward kernel at ``RWKV_BWD_SHAPES``, bf16, log-decay as
    ``rwkv6_inputs`` draws it: all five gradients against autograd through
    the plain version within BF16_TOL x max(1, |ref|) (each gate's margin
    printed); kernel time (events, device), the plain VJP's and the bounds
    (bytes; the products as fp32 vector work)."""
    from repro_torch.kernels import rwkv6_scan as krwkv
    rows = []
    for shape in RWKV_BWD_SHAPES:
        b, t, h, dk = shape
        r, k, v, g = (_rand(shape, torch.bfloat16, gen) for _ in range(4))
        lw = -torch.exp(-4.0 + 0.8 * _rand(shape, torch.float32, gen))
        args = (r, k, v, lw, 0.3 * _rand(shape[2:], torch.float32, gen), g)
        got, ref = krwkv.rwkv6_bwd_cuda(*args), _wkv6_plain_vjp(*args)
        margins = check_gates(f"rwkv6 backward B={b} T={t}", {
            name: gate(a, e, BF16_TOL, True)
            for name, a, e in zip(("dr", "dk", "dv", "dlog_w", "du"), got, ref)})
        del got, ref
        kern = [lambda: krwkv.rwkv6_bwd_cuda(*args)]
        ms, dev_ms = sync_time_ms(kern, iters=50), device_ms(kern, iters=20)
        plain_ms = sync_time_ms([lambda: _wkv6_plain_vjp(*args)], iters=3, warmup=1)
        nbytes = rwkv6_bwd_bytes(*shape)
        b_ms = nbytes / PEAK_BYTES * 1e3
        flops = rwkv6_bwd_flops(*shape)
        f32_ms, f32_by = bound(flops, PEAK_F32_FLOPS, nbytes)
        scratch = b * h * -(-t // krwkv.BWD_CHUNK) * dk * dk * 4
        log(f"[kernels] rwkv6 backward B={b} T={t} H={h} K={dk} bf16: gate margins (error / "
            f"limit, vs autograd through the plain version): {margins}; kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f})  plain VJP {plain_ms:.3f} ms  bound {b_ms:.4f} ms (bytes, "
            f"{nbytes / 1e6:.1f} MB; the state scratch {scratch / 1e6:.1f} MB written and read "
            f"again adds {2 * scratch / PEAK_BYTES * 1e3:.4f}), as fp32 vector work "
            f"{f32_ms:.4f} ms ({f32_by}; {flops / 1e9:.2f} GFLOP)")
        rows.append(dict(shape=f"B={b} T={t} H={h} K={dk} bf16", ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                         bound_fp32_vector_ms=f32_ms, margins=margins))
        del args, r, k, v, g, lw
    results["rwkv6_scan_bwd"] = dict(
        name="rwkv6_scan_bwd", route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_bwd.cu",
        replaces="none: the reference's backward is the AD of its oracle "
                 "(src/repro/kernels/ops.py, _rwkv6_b)",
        library="none", rows=rows, **{k: rows[0][k] for k in ("ms", "device_ms", "plain_ms",
                                                               "bound_ms", "bound_by")})


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


def chat_scenario(model, params, vocab: int, seed: int):
    """Paged serving with the prefix cache under pressure, small enough for
    the CPU: 5 requests behind a shared 16-token prefix on a 14-block pool
    of 4-token blocks (preemptions), one request that can never fit
    (rejected), and after 4 steps three repeats of the first two prompts
    (full hits; the two copies of one prompt share its tail block, so one
    COW-splits).  Returns ({rid: tokens}, snapshot, {rid: prompt})."""
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=16)
    prompts = [np.concatenate([head, rng.integers(0, vocab, size=n)]) for n in (3, 9, 6, 11, 5)]
    eng = ServeEngine(model, params, max_batch=4, max_len=48,
                      config=EngineConfig(kv_blocks=14, kv_block_size=4, prefix_cache=True))
    sent = {eng.submit(p, max_new=8): p for p in prompts}
    eng.submit(np.concatenate([prompts[0], prompts[1]]), max_new=20)
    for _ in range(4):
        eng.step()
    sent.update({eng.submit(p, max_new=8): p for p in (prompts[0], prompts[0], prompts[1])})
    done = eng.run_until_drained()
    snap = eng.metrics_snapshot()
    if (snap.prefill_skipped < 1 or snap.cow_splits < 1 or snap.preemptions < 1
            or snap.rejected != 1 or sorted(r.rid for r in done) != sorted(sent)):
        raise AssertionError(f"chat scenario: {len(done)} finished, full hits "
                             f"{snap.prefill_skipped}, COW splits {snap.cow_splits}, "
                             f"preemptions {snap.preemptions}, rejected {snap.rejected}")
    return {r.rid: r.out_tokens for r in done}, snap, sent


def check_greedy(cpu, p_cpu, served: dict, prompts: dict, max_len: int) -> tuple:
    """Every token served for ``prompts`` ({rid: prompt}) is a greedy choice
    of the CPU model fed the same tokens, up to two logits' worth of the
    bf16 tolerance: (tokens that are the CPU's exact argmax, tokens)."""
    v = cpu.cfg.vocab_size
    exact = n = 0
    for rid, prompt in prompts.items():
        out = served[rid]
        logits, cache = cpu.prefill(p_cpu, {"tokens": torch.as_tensor(prompt)[None]}, max_len)
        for j, tok in enumerate(out):
            row = logits[0, :v].float()
            if row[tok] < row.max() - 2 * BF16_MODEL_TOL:
                raise AssertionError(f"request {rid} token {j}: the card served {tok} "
                                     f"(CPU logit {row[tok]:.4f}), the CPU's best logit "
                                     f"is {row.max():.4f}")
            exact += int(tok == int(torch.argmax(row)))
            n += 1
            if j + 1 < len(out):
                logits, cache = cpu.decode_step(p_cpu, cache, torch.tensor([[tok]]))
    return exact, n


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
    check_path(counts, DENSE_PATH, "fp32 parity, dense")
    log(f"[parity] reduced granite fp32 ({n_layers} layers): card vs CPU logits max |err| "
        f"{worst:.3e} (tol {MODEL_TOL}); greedy ServeEngine tokens identical for "
        f"{len(t_cpu)} requests; launches {counts}")
    # the paged engine with the prefix cache, same weights, card vs CPU
    with torch.no_grad():
        c_cpu, _, _ = chat_scenario(cpu, p_cpu, cfg.vocab_size, seed=13)
        ops.reset_launch_counts()
        c_gpu, snap, _ = chat_scenario(gpu, p_gpu, cfg.vocab_size, seed=13)
        counts = ops.launch_counts()
    if c_cpu != c_gpu:
        raise AssertionError(f"paged greedy tokens differ card vs CPU: {c_gpu} vs {c_cpu}")
    check_path(counts, PAGED_PATH, "fp32 parity, paged")
    log(f"[parity] paged + prefix cache fp32: greedy tokens identical card vs CPU for "
        f"{len(c_cpu)} requests ({snap.prefill_skipped} full hits, {snap.cow_splits} COW "
        f"splits, {snap.preemptions} preemptions, {snap.rejected} rejected, "
        f"{snap.prefix_hit_tokens} of {snap.prefix_query_tokens} prompt tokens from the "
        f"cache); launches {counts}")
    for arch in RECURRENT_ARCHS:
        recurrent_parity(arch, "float32", n_layers)
    for arch in FAMILY_ARCHS:
        family_parity(arch, n_layers)


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
        counts = ops.launch_counts()
        exact_argmax, n_tokens = check_greedy(cpu, p_cpu, served, dict(enumerate(prompts)),
                                              max_len)
        ops.reset_launch_counts()
        c_served, c_snap, c_prompts = chat_scenario(gpu, p_gpu, v, seed=14)
        c_counts = ops.launch_counts()
        c_exact, c_n = check_greedy(cpu, p_cpu, c_served, c_prompts, max_len)
    check_path(counts, DENSE_PATH, "bf16 parity, dense")
    check_path(c_counts, PAGED_PATH, "bf16 parity, paged")
    snap = eng.metrics_snapshot()
    log(f"[parity-bf16] granite geometry, d_model {cfg.d_model}, {n_layers} layers, bf16: "
        f"card vs CPU logits max |err| {worst:.4f} (tol {BF16_MODEL_TOL}); distance from an "
        f"fp32 CPU run: card {gpu_drift:.4f}, CPU bf16 {cpu_drift:.4f}; {len(prompts)} "
        f"served requests in {snap.prefill_dispatches} prefill dispatches, {n_tokens} "
        f"tokens all greedy choices of the CPU model ({exact_argmax} its exact argmax); "
        f"launches {counts}")
    log(f"[parity-bf16] paged + prefix cache: {len(c_prompts)} served requests "
        f"({c_snap.prefill_skipped} full hits, {c_snap.cow_splits} COW splits, "
        f"{c_snap.preemptions} preemptions), {c_n} tokens all greedy choices of the CPU model "
        f"({c_exact} its exact argmax); launches {c_counts}")
    for arch in RECURRENT_ARCHS:
        recurrent_parity(arch, "bfloat16", n_layers)


def recurrent_launches(cfg) -> tuple:
    """Launches of one prefill dispatch and of one decode step of an rwkv6
    or zamba2 model, by kernel: the WKV6 or SSD kernel once a layer and
    flash once a shared-block firing in a prefill, the decode kernel once a
    firing in a decode step (which runs the scans as token recurrences), and
    RMSNorm two a layer, two a firing and the final norm in both."""
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import n_attn_applications
    zero = dict.fromkeys(ops.launch_counts(), 0)
    n_layers, n_attn = cfg.n_layers, n_attn_applications(cfg)
    norms = 2 * n_layers + 2 * n_attn + 1
    if cfg.rwkv:
        return dict(zero, rwkv6_scan=n_layers, rmsnorm=norms), dict(zero, rmsnorm=norms)
    return (dict(zero, mamba2_ssd=n_layers, flash_attention=n_attn, rmsnorm=norms),
            dict(zero, decode_attention=n_attn, rmsnorm=norms))


def check_launches(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def check_served_kernels(tag: str, drive, want: dict, worst_args: dict | None = None) -> dict:
    """Run ``drive()`` with each kernel's CUDA wrapper (the function ``ops``
    routes a card tensor to) replaced by one that also runs the kernel's
    plain version on the same inputs and gates the two, so every kernel is
    held at the shapes, strides and values the served path gives it: a bf16
    output within BF16_TOL x max(1, |ref|) elementwise, an fp32 one (the
    SSD's final state) within SCAN_F32_TOL x max|ref|; the WKV6 backward's
    five gradients (against autograd through the plain version) all within
    BF16_TOL x max(1, |ref|), its inputs being bf16.  ``want``: the calls
    by kernel that ``drive`` must make (or a function that gives them once
    ``drive`` has run).  Returns, by kernel, the calls, the
    shapes of their first two inputs and the worst margin (error / limit);
    ``worst_args``, when given, receives by kernel the inputs of its call
    with the worst margin."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba2_ssd as kssd
    from repro_torch.kernels import paged_attention as kpaged
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import rwkv6_scan as krwkv
    pairs = {"flash_attention": (kfa, "flash_attention_cuda", kfa.flash_attention_plain),
             "decode_attention": (kdec, "decode_attention_cuda", kdec.decode_attention_plain),
             "paged_decode_attention": (kpaged, "paged_decode_attention_cuda",
                                        kpaged.paged_decode_attention_plain),
             "rmsnorm": (krms, "rmsnorm_cuda", krms.rmsnorm_plain),
             "rwkv6_scan": (krwkv, "rwkv6_cuda", krwkv.rwkv6_chunked_plain),
             "rwkv6_scan_bwd": (krwkv, "rwkv6_bwd_cuda", _wkv6_plain_vjp),
             "mamba2_ssd": (kssd, "mamba2_ssd_cuda", kssd.mamba2_ssd_chunked_plain)}
    seen = {name: dict(calls=0, shapes=set(), margin=0.0) for name in pairs}

    def checked(name, kernel, plain):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            rec = seen[name]
            for got, r in zip(*((out, ref) if isinstance(out, tuple) else ((out,), (ref,)))):
                if got.shape != r.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{tag} {name} at {tuple(args[0].shape)}: shape "
                                         f"{tuple(got.shape)} vs {tuple(r.shape)} or "
                                         f"non-finite output")
                m = (gate(got, r, BF16_TOL, True) if got.dtype == torch.bfloat16
                     or name == "rwkv6_scan_bwd" else gate(got, r, SCAN_F32_TOL, False))
                if worst_args is not None and (name not in worst_args or m > rec["margin"]):
                    worst_args[name] = args
                rec["margin"] = max(rec["margin"], m)
            rec["calls"] += 1
            rec["shapes"].add(tuple(tuple(a.shape) for a in args[:2]))
            return out
        return call

    originals = {name: getattr(mod, attr) for name, (mod, attr, _) in pairs.items()}
    try:
        for name, (mod, attr, plain) in pairs.items():
            setattr(mod, attr, checked(name, originals[name], plain))
        drive()
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr, _) in pairs.items():
            setattr(mod, attr, originals[name])
    calls = {name: rec["calls"] for name, rec in seen.items()}
    if callable(want):
        want = want()
    if calls != want:
        raise AssertionError(f"{tag} served-shape check: calls {calls}, expected {want}")
    check_gates(f"{tag} served shapes", {name: rec["margin"] for name, rec in seen.items()
                                         if rec["calls"]})
    return {name: dict(calls=rec["calls"], shapes=sorted(rec["shapes"]),
                       margin=rec["margin"]) for name, rec in seen.items() if rec["calls"]}


def recurrent_parity(arch: str, dtype: str, n_layers: int = 4) -> None:
    """Reduced rwkv6 or zamba2 (``n_layers`` layers) on the card against the
    same weights on the CPU, served over the recurrent backend.  Prefill at
    B=1 and exact prompt lengths 1, 2, 37 and 100: logits and every state
    leaf; 4 decode steps from the longest; greedy ServeEngine tokens (fp32:
    identical to the CPU engine's; bf16: each a greedy choice of the CPU
    model); a run with one lane preempted after 2 steps gives the same
    tokens with one prefill dispatch a request.  fp32 holds logits and
    states within MODEL_TOL x max(1, |ref|); bf16 logits within
    BF16_MODEL_TOL, states within BF16_MODEL_TOL x max(1, |ref|)."""
    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.convert import move_params
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.backends import lane_leaves
    from repro_torch.serving.engine import ServeEngine
    fp32 = dtype == "float32"
    tol = MODEL_TOL if fp32 else BF16_MODEL_TOL
    tag = f"[parity{'' if fp32 else '-bf16'}] {arch}"
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers)
    rcfg = RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False)
    cpu, gpu = build_model(cfg, rcfg, device="cpu"), build_model(cfg, rcfg, device="cuda")
    p_cpu = cpu.init(0)
    p_gpu = move_params(p_cpu, "cuda")
    per_prefill, per_step = recurrent_launches(cfg)
    rng = np.random.default_rng(2)
    v, max_len = cfg.vocab_size, 128
    worst_logits = worst_state = 0.0
    with torch.no_grad():
        for t in (1, 2, 37, 100):
            toks = torch.as_tensor(rng.integers(0, v, size=(1, t)))
            l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, max_len)
            ops.reset_launch_counts()
            l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, max_len)
            check_launches(ops.launch_counts(), per_prefill, f"{tag} prefill T={t}")
            worst_logits = max(worst_logits, check_close(
                f"{tag} prefill T={t} logits", l_g.cpu()[:, :v], l_c[:, :v], tol, fp32))
            ref = lane_leaves(c_c, 0)
            for path, leaf in lane_leaves(c_g, 0).items():
                worst_state = max(worst_state, check_close(
                    f"{tag} prefill T={t} state {'/'.join(path)}", leaf.cpu(), ref[path], tol,
                    True))
        for i in range(4):
            nxt = torch.argmax(l_c[:, :v], -1)[:, None]
            l_c, c_c = cpu.decode_step(p_cpu, c_c, nxt)
            ops.reset_launch_counts()
            l_g, c_g = gpu.decode_step(p_gpu, c_g, nxt.cuda())
            check_launches(ops.launch_counts(), per_step, f"{tag} decode step")
            worst_logits = max(worst_logits, check_close(
                f"{tag} decode {i} logits", l_g.cpu()[:, :v], l_c[:, :v], tol, fp32))
        prompts = [rng.integers(0, v, size=n) for n in (5, 17, 33, 9, 60)]
        kw = dict(max_batch=2, max_len=max_len)
        served, eng = _serve(gpu, p_gpu, prompts, 8, **kw)
        if eng.backend.name != "recurrent":
            raise AssertionError(f"{tag}: served over {eng.backend.name} lanes")
        if fp32:
            want, _ = _serve(cpu, p_cpu, prompts, 8, **kw)
            if served != want:
                raise AssertionError(f"{tag}: greedy tokens differ card vs CPU: {served} vs "
                                     f"{want}")
            verdict = f"greedy tokens identical card vs CPU for {len(prompts)} requests"
        else:
            exact, n = check_greedy(cpu, p_cpu, served, dict(enumerate(prompts)), max_len)
            verdict = (f"{n} served tokens all greedy choices of the CPU model ({exact} its "
                       f"exact argmax)")
        pre = ServeEngine(gpu, p_gpu, **kw)
        for prompt in prompts:
            pre.submit(prompt, max_new=8)
        pre.step()
        pre.step()
        pre.preempt(0)
        again = {r.rid: r.out_tokens for r in pre.run_until_drained()}
    snap = pre.metrics_snapshot()
    if again != served or snap.prefill_dispatches != len(prompts) or snap.resumes < 1:
        raise AssertionError(f"{tag} preempted run: tokens {again} vs {served}, "
                             f"{snap.prefill_dispatches} prefill dispatches for {len(prompts)} "
                             f"requests, {snap.resumes} resumes")
    log(f"{tag} reduced, {n_layers} layers, {dtype}, recurrent backend: card vs CPU logits "
        f"max |err| {worst_logits:.3e}, states max |err| {worst_state:.3e} (tol {tol}"
        f"{' x max(1, |ref|)' if fp32 else ''}); launches a prefill {per_prefill}, a decode "
        f"step {per_step}; {verdict}; with lane 0 preempted after 2 steps the same tokens in "
        f"{snap.prefill_dispatches} prefill dispatches ({snap.resumes} resumes)")


# ---------------------------------------------------------------------------
# phases 6-7: full-width granite-8b served through ServeEngine
# ---------------------------------------------------------------------------

def full_width_model(n_layers: int = 0):
    """granite-8b at its published widths, bf16, random weights from seed 0
    drawn on the card: (model, params)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.models.api import build_model
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
    return model, params


def add_launches(results: dict, counts: dict, path: str) -> None:
    """Record one serving path's launch counts in the kernels' entries."""
    for name, n in counts.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("launches_by_path", {})[path] = n
        entry["launches"] = sum(entry["launches_by_path"].values())


def phase_serve(results: dict, model, params, n_requests: int = 16,
                max_new: int = 32) -> None:
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    cfg = model.cfg
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
        check_path(counts, DENSE_PATH, "dense serving run")
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
    profile_step(lambda: eng.backend.step(params, toks, active), "decode step, batch 8",
                 share="DenseLayout")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 512)),
                             device=model.device)
    lens = torch.full((4,), 512, dtype=torch.int32, device=model.device)
    profile_step(lambda: model.decode_state.batched_prefill(params, {"tokens": prompt}, lens,
                                                            max_len),
                 "prefill dispatch, 4 x 512 tokens")
    add_launches(results, counts, "dense")


def phase_serve_paged(results: dict, model, params) -> None:
    """Chat traffic over the paged pool with the prefix cache: 32 greedy
    requests, each a shared 512-token system prompt and a unique suffix of
    16-240 tokens, max_new 32, on max_batch 16 lanes of max_len 1024; once
    they are done, 4 repeats of the last two finished prompts (full hits,
    each pair sharing its tail block: COW splits).  184 16-token blocks
    (184 x 2.25 MiB = 414 MiB at granite-8b's 147,456 B of K/V a token)
    admit all 16 lanes but not their growth, so lanes are preempted.
    The same prompts then go through a dense engine for comparison."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    cfg = model.cfg
    max_batch, max_len, bs, max_new, n_blocks = 16, 1024, 16, 32, 184
    config = EngineConfig(kv_blocks=n_blocks, kv_block_size=bs, prefix_cache=True)
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, size=512)
    lens = rng.integers(16, 241, size=32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=int(n))])
               for n in lens]
    with torch.no_grad():
        warm = ServeEngine(model, params, max_batch=2, max_len=max_len,
                           config=EngineConfig(kv_blocks=8, kv_block_size=bs))
        warm.submit(rng.integers(0, cfg.vocab_size, size=20), max_new=4)
        warm.run_until_drained()
        del warm
        eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len, config=config)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sent = {eng.submit(p, max_new=max_new): p for p in prompts}
        eng.run_until_drained()
        last = [r.rid for r in eng.finished][-2:]
        sent.update({eng.submit(sent[rid], max_new=max_new): sent[rid]
                     for rid in (last[0], last[0], last[1], last[1])})
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    snap = eng.metrics_snapshot()
    if sorted(r.rid for r in done) != sorted(sent) or any(
            len(r.out_tokens) != max_new for r in done):
        raise AssertionError(f"{len(done)}/{len(sent)} requests finished")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    if (snap.prefix_hit_tokens <= 0 or snap.prefill_skipped < 1 or snap.cow_splits < 1
            or snap.preemptions < 1):
        raise AssertionError(f"paged run: prefix hit tokens {snap.prefix_hit_tokens}, full "
                             f"hits {snap.prefill_skipped}, COW splits {snap.cow_splits}, "
                             f"preemptions {snap.preemptions}")
    check_path(counts, PAGED_PATH, "paged serving run")
    if counts["paged_decode_attention"] != cfg.n_layers * eng.steps:
        raise AssertionError(f"{counts['paged_decode_attention']} paged launches in "
                             f"{eng.steps} decode steps of {cfg.n_layers} layers")
    gen_tokens = sum(len(r.out_tokens) for r in done)
    dense_positions = max_batch * max_len
    log(f"[serve-paged] {len(sent)} chat requests (512-token shared system prompt + 16-240, "
        f"max_new {max_new}; the last 4 repeats), max_batch {max_batch}, max_len {max_len}, "
        f"{n_blocks} blocks of {bs}: {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} tok/s; {snap.prefill_dispatches} prefill dispatches, "
        f"{eng.steps} decode steps")
    log(f"[serve-paged] TTFT mean {snap.ttft.mean * 1e3:.1f} ms p95 {snap.ttft.p95 * 1e3:.1f} ms; "
        f"TPOT mean {snap.tpot.mean * 1e3:.2f} ms; prefix hits {snap.prefix_hit_tokens} of "
        f"{snap.prefix_query_tokens} prompt tokens; {snap.prefill_skipped} full hits, "
        f"{snap.cow_splits} COW splits, {snap.preemptions} preemptions, {snap.resumes} resumes, "
        f"{snap.cache_evictions} evictions")
    log(f"[serve-paged] KV blocks peak {snap.kv_blocks_peak} ({snap.kv_blocks_peak * bs} "
        f"positions) against the {dense_positions} positions ({dense_positions // bs} blocks) "
        f"dense lanes hold; shared blocks peak {snap.kv_shared_blocks_peak}; launches {counts}")
    # the same prompts over dense lanes: tokens agree unless the two decode
    # kernels' different summation orders tip a bf16 argmax
    with torch.no_grad():
        dense = ServeEngine(model, params, max_batch=max_batch, max_len=max_len)
        for p in sent.values():
            dense.submit(p, max_new=max_new)
        ref = {r.rid: r.out_tokens for r in dense.run_until_drained()}   # same rids
    same = sum(a == b for r in done for a, b in zip(r.out_tokens, ref[r.rid]))
    same_req = sum(r.out_tokens == ref[r.rid] for r in done)
    log(f"[serve-paged] against a dense run of the same prompts: {same} of {gen_tokens} tokens "
        f"agree position by position, {same_req} of {len(done)} requests identical")
    add_launches(results, counts, "paged")
    # where a paged step's time goes: 16 busy lanes behind the shared prompt
    # (612 positions each), whole engine steps (lane preparation, table
    # upload, decode, sampling)
    with torch.no_grad():
        for _ in range(max_batch):
            eng.submit(np.concatenate([system, rng.integers(0, cfg.vocab_size, size=100)]),
                       max_new=16)
        for _ in range(6):                 # admission packs the pool's free budget
            if eng.active() == max_batch:
                break
            eng.step()
        if eng.active() != max_batch or eng.metrics_snapshot().preemptions != snap.preemptions:
            raise AssertionError(f"{eng.active()} of {max_batch} lanes busy")
        profile_step(eng.step, f"paged engine step, batch {max_batch}, 612 positions a lane",
                     share="PagedLayout")


# ---------------------------------------------------------------------------
# phases 8-9: the stage plane and the agentic tool loop on granite-8b
# (phase 10, recurrent serving, follows them)
# ---------------------------------------------------------------------------

def unsplit_launches(model, params, prompt: np.ndarray, max_batch: int, max_len: int) -> tuple:
    """Launches by kernel of one B=1 exact-length prefill of ``prompt`` and
    of one decode step of ``max_batch`` dense lanes, by the unsplit model."""
    from repro_torch.kernels import ops
    with torch.no_grad():
        ops.reset_launch_counts()
        model.prefill(params, {"tokens": torch.as_tensor(prompt[None], device=model.device)},
                      max_len)
        per_prefill = ops.launch_counts()
        cache = model.init_cache(max_batch, max_len)
        ops.reset_launch_counts()
        model.decode_step(params, cache, torch.zeros((max_batch, 1), dtype=torch.int64,
                                                     device=model.device))
        per_step = ops.launch_counts()
    return per_prefill, per_step


def drive_stages(eng, prompts, max_new: int, recut_to) -> dict:
    """Serve ``prompts`` on PipelineEngine ``eng`` (after a warm-up request):
    6 steps, then ``recut_to`` (or, for None, every lane preempted), then
    drain; the run's tokens, step reports either side of the cut, launches,
    wall time and the cut's bytes and seconds."""
    from repro_torch.kernels import ops
    eng.submit(prompts[0][:20], max_new=4)                         # warm-up
    eng.run_until_drained()
    torch.cuda.synchronize()
    eng.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new=max_new)
    before = [eng.step_paced() for _ in range(6)]
    t_cut = time.perf_counter()
    if recut_to is None:
        moved = 0
        for slot, req in enumerate(eng.slots):
            if req is not None:
                eng.preempt(slot)
    else:
        moved = eng.recut(recut_to)
    cut_s = time.perf_counter() - t_cut
    after = []
    while eng.active() or eng.scheduler.depth:
        after.append(eng.step_paced())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens={r.rid: r.out_tokens for r in eng.finished}, before=before, after=after,
                counts=ops.launch_counts(), wall=wall, moved=moved, cut_s=cut_s,
                snap=eng.metrics_snapshot())


def drive_exact_serve(model, params, prompts, max_new: int, max_batch: int,
                      max_len: int) -> dict:
    """The split's witness outside PipelineEngine: a ServeEngine with a
    prefill bucket for every length and one request a dispatch (each
    request prefilled alone at its exact length, as a stage prefills it),
    the same warm-up, 6 steps, then every lane preempted, as the recut
    preempts them; the same functions on the same shapes as the one-stage
    PipelineEngine.  Its tokens by rid."""
    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len,
                      **exact_prefill(max_len))
    eng.submit(prompts[0][:20], max_new=4)                         # warm-up
    eng.run_until_drained()
    eng.reset_stats()
    for p in prompts:
        eng.submit(p, max_new=max_new)
    for _ in range(6):
        eng.step()
    for slot, req in enumerate(eng.slots):
        if req is not None:
            eng.preempt(slot)
    return {r.rid: r.out_tokens for r in eng.run_until_drained()}


def wire_summary(reports: list, n_boundaries: int) -> str:
    """Frames and bytes per boundary, prefill and decode, and the mean
    decode wall of each stage, over ``reports``."""
    steps = [r for r in reports if r is not None and r.decode_step]
    admissions = sum(r.admissions for r in reports if r is not None)
    parts = []
    for i in range(n_boundaries):
        pb = sum(r.prefill_frame_bytes[i] for r in reports if r is not None)
        db = sum(r.decode_frame_bytes[i] for r in steps)
        parts.append(f"boundary {i}: prefill {admissions} frames {pb} B, decode {len(steps)} "
                     f"frames {db} B ({db // max(1, len(steps))} B a frame)")
    walls = [1e3 * sum(r.decode_stage_wall_s[i] for r in steps) / max(1, len(steps))
             for i in range(n_boundaries + 1)]
    parts.append("decode wall a step by stage " + ", ".join(f"{w:.3f}" for w in walls) + " ms")
    return "; ".join(parts)


def phase_serve_stages(results: dict, model, params, n_requests: int = 16,
                       max_new: int = 32) -> None:
    """granite-8b split into layer-range stages, every stage on the card:
    a PipelineEngine (max_batch 8, max_len 1024) at the cut
    ``plan_decode_split`` picks for [H100, IPHONE_16], serving the dense
    serve phase's 16 greedy requests (16-600 prompt tokens, max_new 32);
    after 6 steps it is recut to the plan for [H100, IPHONE_16, IPHONE_16].
    Gates: its tokens equal a one-stage PipelineEngine's (cuts ``()``, every
    lane preempted at the same step) bit for bit, and those of a ServeEngine
    that prefills each request alone at its exact length and preempts at
    the same step (:func:`drive_exact_serve`: an engine apart, over the
    same functions on the same shapes); both PipelineEngine runs launch
    exactly the unsplit model's kernels per prefill dispatch and per
    decode step.
    Then each kernel against its plain version at the stage shapes (B=1
    stage prefills of 37 and 600 tokens, a full-batch stage decode step),
    and the card's readings for the H100 profile: a boundary frame's host
    round trip, decode steps a second at batch 8, prefill tokens a second."""
    from repro_torch.hw.specs import H100, IPHONE_16
    from repro_torch.models.api import param_bytes
    from repro_torch.serving.pipeline_decode import PipelineEngine, plan_decode_split
    from repro_torch.wire import codec
    tag = "[serve-stages]"
    cfg = model.cfg
    max_batch, max_len = 8, 1024
    plans = [plan_decode_split(model, params, devs, max_batch=max_batch, max_len=max_len)
             for devs in ([H100, IPHONE_16], [H100, IPHONE_16, IPHONE_16])]
    for plan, what in zip(plans, ("H100 + iPhone 16", "H100 + 2 x iPhone 16")):
        log(f"{tag} plan for {what}: cuts {plan.cuts}, stage memory "
            f"{[round(m / 1e9, 3) for m in plan.stage_mem_bytes]} GB (fits {plan.fits}), "
            f"predicted step {plan.step_seconds * 1e3:.3f} ms (stages "
            f"{[round(s * 1e3, 3) for s in plan.stage_seconds]}, links "
            f"{[round(s * 1e3, 4) for s in plan.comm_seconds]} ms)")
        if not plan.feasible:
            raise AssertionError(f"{tag} no feasible cut for {what}")
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, size=20)          # the dense serve's warm-up draw
    lengths = np.linspace(16, 600, n_requests).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    per_prefill, per_step = unsplit_launches(model, params, prompts[0], max_batch, max_len)
    runs = {}
    with torch.no_grad():
        for name, cuts, recut_to in (("split", plans[0].cuts, plans[1].cuts),
                                     ("one-stage", (), None)):
            eng = PipelineEngine(model, params, max_batch=max_batch, max_len=max_len, cuts=cuts)
            bytes_before = eng.stage_param_bytes
            runs[name] = dict(drive_stages(eng, prompts, max_new, recut_to), eng=eng,
                              bytes_before=bytes_before, bytes_after=eng.stage_param_bytes)
        witness = drive_exact_serve(model, params, prompts, max_new, max_batch, max_len)
    split, one = runs["split"], runs["one-stage"]
    eng = split["eng"]
    done = split["tokens"]
    if len(done) != n_requests or any(len(t) != max_new for t in done.values()):
        raise AssertionError(f"{tag}: {len(done)}/{n_requests} requests finished with "
                             f"{[len(t) for t in done.values()]} tokens")
    if any(not 0 <= t < cfg.vocab_size for ts in done.values() for t in ts):
        raise AssertionError(f"{tag}: a generated token lies outside the vocabulary")
    if done != one["tokens"]:
        diff = sum(a != b for rid in done for a, b in zip(done[rid], one["tokens"][rid]))
        raise AssertionError(f"{tag}: the split's tokens differ from the one-stage engine's "
                             f"at {diff} positions")
    if done != witness:
        diff = sum(a != b for rid in done for a, b in zip(done[rid], witness.get(rid, [])))
        raise AssertionError(f"{tag}: the split's tokens differ from the exact-length "
                             f"ServeEngine's at {diff} positions (rids {sorted(done)} against "
                             f"{sorted(witness)})")
    for name, run in runs.items():
        snap = run["snap"]
        want = {k: per_prefill[k] * snap.prefill_dispatches + per_step[k] * snap.steps
                for k in per_prefill}
        check_launches(run["counts"], want, f"{tag} {name} run of {snap.prefill_dispatches} "
                                            f"prefill dispatches and {snap.steps} decode steps")
    snap = split["snap"]
    gen_tokens = sum(len(t) for t in done.values())
    log(f"{tag} granite-8b, cuts {plans[0].cuts} then {plans[1].cuts} after 6 steps, every "
        f"stage on the card: {n_requests} requests, prompts {int(lengths.min())}-"
        f"{int(lengths.max())} tokens, max_new {max_new}: {gen_tokens} tokens in "
        f"{split['wall']:.3f} s = {gen_tokens / split['wall']:.1f} tok/s (one stage: "
        f"{gen_tokens / one['wall']:.1f}); {snap.prefill_dispatches} prefill dispatches, "
        f"{snap.steps} decode steps; tokens bit-equal to the one-stage engine's and to an "
        f"exact-length ServeEngine's preempted at the same step")
    log(f"{tag} TTFT mean {snap.ttft.mean * 1e3:.1f} ms p95 {snap.ttft.p95 * 1e3:.1f} ms; TPOT "
        f"mean {snap.tpot.mean * 1e3:.2f} ms (one stage: TTFT {one['snap'].ttft.mean * 1e3:.1f} "
        f"ms, TPOT {one['snap'].tpot.mean * 1e3:.2f} ms)")
    log(f"{tag} param bytes by stage {list(split['bytes_before'])} then "
        f"{list(split['bytes_after'])} (the unsplit tree {param_bytes(params)}); the recut "
        f"moved {split['moved']} B of layers in {split['cut_s'] * 1e3:.3f} ms (preempting "
        f"{sum(r.preemptions for r in eng.finished)} lanes and building the stages)")
    log(f"{tag} 2 stages: " + wire_summary(split["before"], 1))
    log(f"{tag} 3 stages: " + wire_summary(split["after"], 2))
    log(f"{tag} one stage: " + wire_summary(one["before"] + one["after"], 0))
    log(f"{tag} launches a prefill dispatch {per_prefill}, a decode step {per_step}, split and "
        f"unsplit alike; the run's {split['counts']}")

    # every kernel at the stage shapes: two B=1 stage prefills and a
    # full-batch stage decode step through the 3 stages, against the plain
    # versions on the same inputs
    long_prompt = torch.as_tensor(prompts[-1][None], device=model.device)
    toks = np.zeros((max_batch, 1), np.int32)
    active = np.ones((max_batch,), bool)

    def drive():
        for toks_in in (long_prompt[:, :37], long_prompt):
            x = toks_in
            for i, st in enumerate(eng.stages):
                x, _ = st.prefill(st.params, {"tokens": x} if i == 0 else {"hidden": x})
        x = toks
        for st in eng.stages:
            x = st.backend.step(st.params, x, active)
    with torch.no_grad():
        served = check_served_kernels(tag, drive, {k: 2 * per_prefill[k] + per_step[k]
                                                   for k in per_prefill})
    log(f"{tag} kernels at the stage shapes (B=1 prefills of 37 and {long_prompt.shape[1]} "
        f"tokens, a decode step of {max_batch} lanes over {max_len} positions, through "
        f"{eng.n_stages} stages) against their plain versions, worst margin (error / limit): "
        + "; ".join(f"{k} {v['calls']} calls, first two inputs {v['shapes']}, "
                    f"{v['margin']:.3f}" for k, v in served.items()))
    for name, rec in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})["stages"] = dict(
            rec, shapes=[[list(d) for d in s] for s in rec["shapes"]])

    # the card's readings for the H100 DeviceProfile
    frame = torch.randn((max_batch, 1, cfg.d_model), device=model.device).to(torch.bfloat16)
    frame_bytes = len(codec.dumps(frame))
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        back = codec.loads(codec.dumps(frame)).to(model.device)
    torch.cuda.synchronize()
    trip_s = (time.perf_counter() - t0) / reps
    if not torch.equal(back, frame):
        raise AssertionError(f"{tag}: a boundary frame changed in its round trip")
    hidden = torch.randn((1, long_prompt.shape[1], cfg.d_model),
                         device=model.device).to(torch.bfloat16)
    hidden_bytes = len(codec.dumps(hidden))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        back = codec.loads(codec.dumps(hidden)).to(model.device)
    torch.cuda.synchronize()
    hidden_s = (time.perf_counter() - t0) / 20
    st1 = one["eng"].stages[0]
    with torch.no_grad():
        step_ms = sync_time_ms([lambda: st1.backend.step(st1.params, toks, active)], iters=10,
                               warmup=2)
        prefill_ms = sync_time_ms([lambda: st1.prefill(st1.params, {"tokens": long_prompt})],
                                  iters=5, warmup=1)
    log(f"{tag} H100 profile readings: a {frame_bytes} B boundary frame's host round trip "
        f"{trip_s * 1e3:.4f} ms = link_bw {frame_bytes / trip_s:.4e} B/s (host clock, {reps} "
        f"trips); decode step at batch {max_batch} over {max_len} positions {step_ms:.3f} ms "
        f"= decode_steps_per_s {1e3 / step_ms:.2f}; B=1 prefill of {long_prompt.shape[1]} "
        f"tokens {prefill_ms:.3f} ms = prefill_tokens_per_s "
        f"{long_prompt.shape[1] / prefill_ms * 1e3:.1f} (CUDA events); a prefill frame of "
        f"{long_prompt.shape[1]} tokens ({hidden_bytes} B) {hidden_s * 1e3:.3f} ms = "
        f"{hidden_bytes / hidden_s:.4e} B/s (host clock, 20 trips)")
    add_launches(results, split["counts"], "stages")


def phase_agent(results: dict, model, params) -> None:
    """The paper's §4.3 agent scenario on granite-8b over the paged pool with
    the prefix cache (max_batch 4, max_len 1024, 256 blocks of 16): the
    launcher's three queries against ``VectorDB(n_docs=100_000, dim=384)``
    behind ``ToolExecutor(n_workers=3)`` at 0.5 s a search, run with async
    tools and sync, with a 0 and a 512-token scenario prefix, each on a
    fresh engine.  Gates: the paged path's kernels and no dense decode
    launch; async tool wait under 0.5 x sync's; the same tokens async and
    sync; prefix hits with the prefix.  Then each kernel against its plain
    version at the agent's shapes (one turn behind the prefix)."""
    from repro_torch.kernels import ops
    from repro_torch.offload.tools import ToolExecutor
    from repro_torch.offload.vectordb import VectorDB
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.tool_loop import run_scenario
    tag = "[agent]"
    t0 = time.perf_counter()
    db = VectorDB(n_docs=100_000, dim=384)
    log(f"{tag} VectorDB {db.embeddings.shape} fp32, {db.embeddings.nbytes / 1e6:.1f} MB on the "
        f"host, built in {time.perf_counter() - t0:.2f} s")
    queries = ["google search engine", "apple ipod", "microsoft windows"]
    config = EngineConfig(kv_blocks=256, kv_block_size=16, prefix_cache=True)
    max_batch, max_len = 4, 1024

    def engine():
        return ServeEngine(model, params, max_batch=max_batch, max_len=max_len, config=config)

    def executor():
        ex = ToolExecutor(n_workers=3)
        ex.register("vector_db_begin_search", lambda query, k: db.search_text(query, int(k)),
                    simulated_seconds=0.5)
        return ex

    with torch.no_grad():
        warm = engine()
        warm.submit(np.arange(20), max_new=4)
        warm.run_until_drained()
        del warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        runs = {}
        for prefix in (0, 512):
            for async_tools in (True, False):
                eng, ex = engine(), executor()
                tr = run_scenario(eng, ex, queries, async_tools=async_tools,
                                  prefix_tokens=prefix)
                ex.shutdown()
                runs[prefix, async_tools] = (tr, [r.out_tokens for r in eng.finished],
                                             eng.metrics_snapshot(), eng.steps)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    check_path(counts, PAGED_PATH, "agent runs")
    for (prefix, async_tools), (tr, toks, snap, steps) in runs.items():
        mode = "async" if async_tools else "sync"
        log(f"{tag} prefix {prefix}, {mode} tools: total {tr.total:.3f} s, tool wait "
            f"{tr.time_in('tool_wait'):.3f} s, reason {tr.time_in('reason'):.3f} s, summarize "
            f"{tr.time_in('summarize'):.3f} s; {sum(len(t) for t in toks)} tokens in "
            f"{snap.prefill_dispatches} prefill dispatches and {steps} decode steps; prefix hits "
            f"{snap.prefix_hit_tokens} of {snap.prefix_query_tokens} prompt tokens "
            f"({snap.prefill_skipped} full hits)")
        log(f"{tag}   timeline: " + "; ".join(
            f"{s['kind']} {s['start']:.3f}-{s['end']:.3f}" for s in tr.timeline()))
    for prefix in (0, 512):
        (a, a_toks, a_snap, _), (s, s_toks, _, _) = runs[prefix, True], runs[prefix, False]
        if not a.time_in("tool_wait") < 0.5 * s.time_in("tool_wait"):
            raise AssertionError(f"{tag} prefix {prefix}: async tool wait "
                                 f"{a.time_in('tool_wait'):.3f} s, not under 0.5 x sync's "
                                 f"{s.time_in('tool_wait'):.3f} s")
        if a_toks != s_toks or [len(t) for t in a_toks] != [12, 24, 24, 24]:
            raise AssertionError(f"{tag} prefix {prefix}: async tokens {a_toks} vs sync "
                                 f"{s_toks}")
        if prefix and a_snap.prefix_hit_tokens < 3 * prefix:
            raise AssertionError(f"{tag}: {a_snap.prefix_hit_tokens} prefix hit tokens behind "
                                 f"a {prefix}-token prefix over 4 turns")
    log(f"{tag} launches on the agent path: {counts}")

    # every kernel at the agent's shapes: one turn behind the 512-token prefix
    turn = np.random.default_rng(1).integers(0, model.cfg.vocab_size, size=520)
    per_prefill, per_step = unsplit_launches(model, params, turn, max_batch, max_len)
    per_step = dict(per_step, decode_attention=0,
                    paged_decode_attention=per_step["decode_attention"])
    eng = engine()

    def drive():
        eng.submit(turn, max_new=8)
        eng.run_until_drained()

    def want():
        snap = eng.metrics_snapshot()
        return {k: per_prefill[k] * snap.prefill_dispatches + per_step[k] * eng.steps
                for k in per_prefill}
    with torch.no_grad():
        served = check_served_kernels(tag, drive, want)
    log(f"{tag} kernels at the agent's shapes (a B=1 prefill of 520 tokens, decode over the "
        f"paged pool) against their plain versions, worst margin (error / limit): "
        + "; ".join(f"{k} {v['calls']} calls, first two inputs {v['shapes']}, "
                    f"{v['margin']:.3f}" for k, v in served.items()))
    for name, rec in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})["agent"] = dict(
            rec, shapes=[[list(d) for d in s] for s in rec["shapes"]])
    add_launches(results, counts, "agent")


# ---------------------------------------------------------------------------
# phase serve_spec: speculative decoding on granite-8b and rwkv6-1.6b
# ---------------------------------------------------------------------------

SPEC_K = 3


def prefix_draft(model, params, n_layers: int):
    """The first ``n_layers`` layers of ``model`` (with its embedding, final
    norm and head) as a draft model on its device; the params share the
    target's tensors, so the draft adds no weight bytes."""
    from repro_torch.models.api import build_model
    draft = build_model(dataclasses.replace(model.cfg, n_layers=n_layers), model.rcfg,
                        device=model.device)
    dparams = {k: v for k, v in params.items() if k != "blocks"}
    dparams["blocks"] = params["blocks"][:n_layers]
    return draft, dparams


def own_head(draft, dparams: dict, seed: int = 1):
    """``draft`` untied, under a head of its own drawn from ``seed`` at the
    embedding table's scale: its proposals miss the target's samples, so
    every round rolls back.  (On random weights a tied-embedding model's
    logits are dominated by its input token's own row, so a prefix of it
    proposes what the target samples.)"""
    from repro_torch.models.api import build_model
    table = dparams["embed"]["tok"]
    gen = torch.Generator(device=table.device).manual_seed(seed)
    w = torch.randn((table.shape[1], table.shape[0]), generator=gen, device=table.device)
    head = (w * table.float().std()).to(table.dtype)
    model = build_model(dataclasses.replace(draft.cfg, tie_embeddings=False), draft.rcfg,
                        device=draft.device)
    return model, {**dparams, "head": {"w": head}}


def exact_prefill(max_len: int) -> dict:
    """Engine kwargs that prefill each request alone at its exact length: a
    request's prefill then has the same shapes whenever it is admitted, so a
    spec engine and its plain witness (which admit on other steps) prefill
    it alike, bit for bit."""
    return dict(prefill_buckets=range(1, max_len + 1), max_prefill_batch=1)


def spec_samplings(n: int) -> list:
    """Even requests greedy, odd ones stochastic (temperature 0.8, top_k 50,
    top_p 0.95, one seed each)."""
    from repro_torch.serving.sampling import SamplingParams
    return [None if i % 2 == 0 else
            SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=100 + i)
            for i in range(n)]


def count_spec_work(eng) -> dict:
    """Count a SpecEngine's target windows, draft windows (each followed by
    k single draft steps) and draft prefills, by wrapping the backends'
    verbs; returns the live counts, with the replayed steps of recurrent
    backends beside them (``replays``)."""
    work = dict(target_windows=0, draft_windows=0, draft_prefills=0)

    def counted(fn, key):
        def call(*args, **kw):
            work[key] += 1
            return fn(*args, **kw)
        return call
    eng.backend.verify_step = counted(eng.backend.verify_step, "target_windows")
    eng.draft_backend.verify_step = counted(eng.draft_backend.verify_step, "draft_windows")
    eng.draft_backend.prefill_paste = counted(eng.draft_backend.prefill_paste, "draft_prefills")
    return work


def reset_spec_work(eng, work: dict) -> None:
    work.update(dict.fromkeys(work, 0))
    for backend in (eng.backend, eng.draft_backend):
        if hasattr(backend, "replay_steps"):
            backend.replay_steps = 0


def spec_want(eng, work: dict, target: tuple, draft: tuple) -> dict:
    """The launches by kernel a SpecEngine's counted work must have made:
    its target prefill dispatches and (k + 1) target steps a window plus the
    steps rollback replayed, its draft prefills and (1 + k) draft steps a
    window plus the draft's replays; ``target`` and ``draft`` are each
    model's launches of one prefill dispatch and one decode step."""
    k = eng.spec_k
    n_target = (eng.metrics.prefill_dispatches,
                (k + 1) * work["target_windows"] + getattr(eng.backend, "replay_steps", 0))
    n_draft = (work["draft_prefills"],
               (1 + k) * work["draft_windows"] + getattr(eng.draft_backend, "replay_steps", 0))
    return spec_launches(target, draft, n_target, n_draft)


def serve_run(eng, prompts, samplings, max_new: int, time_rollbacks: bool = False) -> dict:
    """Warm ``eng`` with one short request, then serve ``prompts`` to the
    end (a SpecEngine round by round): tokens in submit order, wall s (host
    clock, synchronised), metrics snapshot, the reports of the rounds that
    ran and the work counted from the end of the warm-up (spec engines),
    and the launches by kernel.  With ``time_rollbacks`` every rollback of
    the served run is timed, synchronised before and after (which slows the
    run): their seconds in total."""
    from repro_torch.kernels import ops
    from repro_torch.serving.speculative import SpecEngine
    spec = isinstance(eng, SpecEngine)
    work = count_spec_work(eng) if spec else {}
    with torch.no_grad():
        eng.submit(prompts[0][:20], max_new=4)
        eng.run_until_drained()
        torch.cuda.synchronize()
        eng.reset_stats()
        if spec:
            reset_spec_work(eng, work)
        rollback_s = [0.0]
        if time_rollbacks:
            def timed(fn):
                def call(slot, n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(slot, n)
                    torch.cuda.synchronize()
                    rollback_s[0] += time.perf_counter() - t0
                return call
            eng.backend.rollback = timed(eng.backend.rollback)
            eng.draft_backend.rollback = timed(eng.draft_backend.rollback)
        ops.reset_launch_counts()
        reports = []
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=max_new, sampling=s) for p, s in zip(prompts, samplings)]
        for _ in range(100_000):
            if not (eng.active() or eng.scheduler.depth):
                break
            if spec:
                reports.append(eng.step_paced())
            else:
                eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    done = {r.rid: r.out_tokens for r in eng.finished}
    if sorted(done) != sorted(rids) or any(len(done[r]) != max_new for r in rids):
        raise AssertionError(f"{len(done)}/{len(rids)} requests finished with "
                             f"{[len(t) for t in done.values()]} tokens")
    return dict(tokens=[done[r] for r in rids], wall=wall, snap=eng.metrics_snapshot(),
                reports=[r for r in reports if r.n_active], counts=counts, work=work,
                rollback_s=rollback_s[0], n_tokens=len(rids) * max_new)


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def spec_launches(target: tuple, draft: tuple, n_target: tuple, n_draft: tuple) -> dict:
    """Launches by kernel of ``n_target`` = (prefills, decode steps) of the
    target and ``n_draft`` of the draft, from each model's launches of one
    prefill dispatch and one decode step (``unsplit_launches``)."""
    return {k: sum(per[k] * n for per, n in zip(target + draft, n_target + n_draft))
            for k in target[0]}


def spec_summary(run: dict, k: int) -> str:
    reps, snap = run["reports"], run["snap"]
    n = max(1, len(reps))
    emitted = sum(r.emitted_tokens for r in reps)
    return (f"{len(reps)} rounds, acceptance {snap.spec_acceptance_rate:.4f} "
            f"({snap.spec_accepted_tokens} of {snap.spec_drafted_tokens} drafted), "
            f"{emitted / n:.3f} tokens emitted a round "
            f"({emitted / max(1, sum(r.n_active for r in reps)):.3f} a lane, of at most {k + 1}); "
            f"{run['n_tokens']} tokens in {run['wall']:.3f} s = "
            f"{run['n_tokens'] / run['wall']:.1f} tok/s, TTFT mean {snap.ttft.mean * 1e3:.1f} ms, "
            f"TPOT mean {snap.tpot.mean * 1e3:.2f} ms; frames a round: draft -> target "
            f"{sum(r.d2t_frame_bytes for r in reps) / n:.1f} B, target -> draft "
            f"{sum(r.t2d_frame_bytes for r in reps) / n:.1f} B")


def plain_summary(run: dict) -> str:
    snap = run["snap"]
    return (f"{run['n_tokens']} tokens in {run['wall']:.3f} s = "
            f"{run['n_tokens'] / run['wall']:.1f} tok/s, {snap.steps} decode steps, TTFT mean "
            f"{snap.ttft.mean * 1e3:.1f} ms, TPOT mean {snap.tpot.mean * 1e3:.2f} ms")


def check_spec_kernels(tag: str, path: str, results: dict, make_engine, prompts, samplings,
                       target: tuple, draft: tuple) -> None:
    """Each kernel of a spec engine's path against its plain version at the
    shapes the path gives it (``check_served_kernels``): a fresh engine from
    ``make_engine()`` admits the two longest prompts and runs two rounds,
    whose calls by kernel must be ``spec_want``'s."""
    made = []

    def drive():
        eng = make_engine()
        made.append((eng, count_spec_work(eng)))
        for p, s in zip(prompts[-2:], samplings[-2:]):
            eng.submit(p, max_new=8, sampling=s)
        eng.step_paced()
        eng.step_paced()
    with torch.no_grad():
        served = check_served_kernels(tag, drive, lambda: spec_want(*made[0], target, draft))
    log(f"{tag} kernels at the spec path's shapes (B=1 exact prefills of "
        f"{[len(p) for p in prompts[-2:]]} tokens and the draft's one shorter, two rounds of "
        f"windows and draft steps) against their plain versions, worst margin (error / "
        f"limit): " + "; ".join(f"{k} {v['calls']} calls, first two inputs {v['shapes']}, "
                                f"{v['margin']:.3f}" for k, v in served.items()))
    for name, rec in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})[path] = dict(
            rec, shapes=[[list(d) for d in s] for s in rec["shapes"]])


def phase_serve_spec(results: dict, model, params, n_requests: int = 16,
                     max_new: int = 32) -> None:
    """Speculative decoding (``SpecEngine``) on one card, in four runs:
    (a) full-width granite-8b (bf16) with its 4-layer prefix as draft, k 3,
    frames through the codec, phase 6's 16 requests half stochastic: tokens
    bit-equal to a plain ServeEngine's (both prefill each request alone at
    its exact length), launches exactly those of the prefills and of (k + 1)
    target and (1 + k) draft steps a round, one round profiled; (a2) the
    prefix under its own head (``own_head``), whose proposals miss: the same
    tokens and launches; (b) the target as its own draft: acceptance exactly
    1.0 and the same tokens;
    (c) granite-8b's full width cut to 4 layers, fp32, 2-layer prefix draft,
    over a paged pool with the prefix cache small enough to preempt: tokens
    equal the paged witness's, every block back after the drain; (d)
    rwkv6-1.6b (24 layers, bf16) over the recurrent backend on both sides,
    2-layer prefix draft: tokens equal the recurrent witness's, the stash's
    bytes and the rollback replays' time a round.  In (a), (c) and (d) each
    kernel of the path is held against its plain version at its shapes."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecEngine
    tag, k = "[serve-spec]", SPEC_K
    cfg = model.cfg
    max_batch, max_len = 8, 1024
    exact = exact_prefill(max_len)
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, size=20)                 # phase 6's warm-up draw
    lengths = np.linspace(16, 600, n_requests).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    samp = spec_samplings(n_requests)
    draft, dparams = prefix_draft(model, params, 4)

    # (a) dense, the 4-layer prefix drafting
    witness = serve_run(ServeEngine(model, params, max_batch, max_len, **exact), prompts, samp,
                        max_new)
    eng = SpecEngine(model, params, draft, dparams, max_batch, max_len, spec_k=k, **exact)
    run = serve_run(eng, prompts, samp, max_new)
    if run["tokens"] != witness["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(run["tokens"], witness["tokens"])) if a != b]
        raise AssertionError(f"{tag} (a) requests {bad} differ from the plain engine's tokens")
    snap = run["snap"]
    tgt = unsplit_launches(model, params, prompts[0], max_batch, max_len)
    drf = unsplit_launches(draft, dparams, prompts[0], max_batch, max_len)
    rounds, work = len(run["reports"]), run["work"]
    if (snap.preemptions or not rounds == snap.spec_rounds == work["target_windows"]
            == work["draft_windows"] or work["draft_prefills"] != n_requests):
        raise AssertionError(f"{tag} (a) {snap.preemptions} preemptions, {rounds} rounds, "
                             f"{snap.spec_rounds} in the metrics, work {work}")
    check_launches(run["counts"], spec_want(eng, work, tgt, drf),
                   f"{tag} (a) run of {snap.prefill_dispatches} target and {n_requests} draft "
                   f"prefills, {rounds} rounds")
    log(f"{tag} (a) granite-8b {cfg.n_layers} layers bf16, draft its {draft.cfg.n_layers}-layer "
        f"prefix, k {k}, max_batch {max_batch}, max_len {max_len}, {n_requests} requests "
        f"({lengths.min()}-{lengths.max()} prompt tokens, max_new {max_new}, 8 greedy, 8 "
        f"stochastic): tokens bit-equal to the plain engine's; {spec_summary(run, k)}")
    log(f"{tag} (a) the plain witness: {plain_summary(witness)}")
    log(f"{tag} (a) launches {nonzero(run['counts'])} = {snap.prefill_dispatches} target "
        f"prefills x {nonzero(tgt[0])} + {n_requests} draft prefills x {nonzero(drf[0])} + "
        f"{rounds} rounds x ({k + 1} target steps x {nonzero(tgt[1])} + {1 + k} draft steps x "
        f"{nonzero(drf[1])})")
    total = dict(run["counts"])

    # one steady round alone (8 lanes, no admission), then a profiled one
    with torch.no_grad():
        for p, s in zip(prompts[:max_batch], samp[:max_batch]):
            eng.submit(p[:64], max_new=64, sampling=s)
        eng.step_paced()
        ops.reset_launch_counts()
        rep = eng.step_paced()
        one = ops.launch_counts()
        want = spec_launches(tgt, drf, (0, k + 1), (0, 1 + k))
        if rep.n_active != max_batch or rep.target_prefill_tokens or rep.draft_prefill_tokens:
            raise AssertionError(f"{tag} steady round {rep}")
        check_launches(one, want, f"{tag} one round of {k + 1} target and {1 + k} draft steps")
        log(f"{tag} (a) one round at batch {max_batch}: launches {nonzero(one)} = {k + 1} target "
            f"steps x {nonzero(tgt[1])} + {1 + k} draft steps x {nonzero(drf[1])}; "
            f"{rep.emitted_tokens} tokens emitted")
        profile_step(eng.step_paced, f"spec round (k {k}, batch {max_batch}, granite-8b + "
                                     f"{draft.cfg.n_layers}-layer draft)")
        eng.run_until_drained()
    check_spec_kernels(f"{tag} (a)", "spec_dense", results,
                       lambda: SpecEngine(model, params, draft, dparams, max_batch, max_len,
                                          spec_k=k, **exact),
                       prompts, samp, tgt, drf)
    del eng

    # (a2) the same prefix under its own head: proposals miss, dense lanes
    # roll back every round
    mis, mparams = own_head(draft, dparams)
    eng = SpecEngine(model, params, mis, mparams, max_batch, max_len, spec_k=k, **exact)
    run = serve_run(eng, prompts, samp, max_new)
    snap = run["snap"]
    if run["tokens"] != witness["tokens"] or not snap.spec_acceptance_rate < 1.0:
        raise AssertionError(f"{tag} (a2) acceptance {snap.spec_acceptance_rate}, tokens equal "
                             f"the witness's: {run['tokens'] == witness['tokens']}")
    check_launches(run["counts"], spec_want(eng, run["work"], tgt, drf),
                   f"{tag} (a2) run, work {run['work']}")
    log(f"{tag} (a2) the prefix under its own random head (a misaligned draft): tokens "
        f"bit-equal to the plain engine's, launches exact; {spec_summary(run, k)}")
    total = {n: total.get(n, 0) + c for n, c in run["counts"].items()}
    del eng

    # (b) the target drafts for itself: every proposal must be accepted
    eng = SpecEngine(model, params, model, params, max_batch, max_len, spec_k=k, **exact)
    run = serve_run(eng, prompts, samp, max_new)
    snap = run["snap"]
    if snap.spec_acceptance_rate != 1.0 or run["tokens"] != witness["tokens"]:
        raise AssertionError(f"{tag} (b) aligned draft: acceptance {snap.spec_acceptance_rate} "
                             f"({snap.spec_accepted_tokens} of {snap.spec_drafted_tokens}), "
                             f"tokens equal the witness's: {run['tokens'] == witness['tokens']}")
    log(f"{tag} (b) the target as its own draft: acceptance exactly 1.0 on greedy and "
        f"stochastic lanes, tokens bit-equal to the plain engine's; {spec_summary(run, k)}")
    total = {n: total.get(n, 0) + c for n, c in run["counts"].items()}
    del eng
    torch.cuda.empty_cache()

    total = spec_paged(results, total)
    total = spec_recurrent(results, total)
    add_launches(results, total, "spec")


def spec_paged(results: dict, total: dict, n_requests: int = 16, max_new: int = 32,
               n_blocks: int = 64) -> dict:
    """Run (c): granite-8b's full width cut to 4 layers, fp32 (TF32 off), a
    2-layer prefix draft, then the prefix under its own head (``own_head``:
    rollbacks free blocks every round); the target over a paged pool of
    ``n_blocks`` 16-token blocks with the prefix cache, too small for 8
    lanes' growth.  Tokens equal a paged ServeEngine's on the same pool;
    each spec engine preempts and gives every block back."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.speculative import SpecEngine
    tag, k = "[serve-spec] (c)", SPEC_K
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=4)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False), device="cuda")
    params = model.init(0)
    draft, dparams = prefix_draft(model, params, 2)
    max_batch, max_len, bs = 8, 1024, 16
    exact = exact_prefill(max_len)

    def config():
        return EngineConfig(kv_blocks=n_blocks, kv_block_size=bs, prefix_cache=True)
    rng = np.random.default_rng(1)
    lengths = np.linspace(16, 600, n_requests).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    samp = spec_samplings(n_requests)
    witness = serve_run(ServeEngine(model, params, max_batch, max_len, config=config(), **exact),
                        prompts, samp, max_new)
    log(f"{tag} the plain witness: {plain_summary(witness)}; {witness['snap'].preemptions} "
        f"preemptions")
    tgt = unsplit_launches(model, params, prompts[0], max_batch, max_len)
    drf = unsplit_launches(draft, dparams, prompts[0], max_batch, max_len)
    paged = {**tgt[1], "decode_attention": 0,
             "paged_decode_attention": tgt[1]["decode_attention"]}
    for what, (d, dp) in (("its 2-layer prefix", (draft, dparams)),
                          ("the prefix under its own random head", own_head(draft, dparams))):
        eng = SpecEngine(model, params, d, dp, max_batch, max_len, spec_k=k, config=config(),
                         **exact)
        run = serve_run(eng, prompts, samp, max_new)
        snap = run["snap"]
        if run["tokens"] != witness["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(run["tokens"], witness["tokens"]))
                   if a != b]
            raise AssertionError(f"{tag} {what}: requests {bad} differ from the paged "
                                 f"engine's tokens")
        if (snap.preemptions < 1 or eng.backend.blocks_in_use != 0
                or (d is not draft and not snap.spec_acceptance_rate < 1.0)):
            raise AssertionError(f"{tag} {what}: {snap.preemptions} preemptions, "
                                 f"{eng.backend.blocks_in_use} blocks in use after the drain, "
                                 f"acceptance {snap.spec_acceptance_rate}")
        check_launches(run["counts"], spec_want(eng, run["work"], (tgt[0], paged), drf),
                       f"{tag} {what}: run, work {run['work']}")
        log(f"{tag} granite-8b full width cut to {cfg.n_layers} layers, fp32, draft {what}, "
            f"paged pool of {n_blocks} blocks of {bs} with the prefix cache: tokens equal the "
            f"paged plain engine's; {snap.preemptions} preemptions, {snap.resumes} resumes, "
            f"{snap.prefill_skipped} full hits, {snap.cow_splits} COW splits, prefix hits "
            f"{snap.prefix_hit_tokens} of {snap.prefix_query_tokens} tokens, blocks peak "
            f"{snap.kv_blocks_peak}, {eng.backend.blocks_in_use} in use after the drain; "
            f"{spec_summary(run, k)}; launches {nonzero(run['counts'])}")
        total = {n: total.get(n, 0) + c for n, c in run["counts"].items()}
    check_spec_kernels(tag, "spec_paged", results,
                       lambda: SpecEngine(model, params, draft, dparams, max_batch, max_len,
                                          spec_k=k, config=config(), **exact),
                       prompts, samp, (tgt[0], paged), drf)
    return total


def spec_recurrent(results: dict, total: dict, n_requests: int = 8, max_new: int = 32) -> dict:
    """Run (d): rwkv6-1.6b at full width and depth, bf16, the recurrent
    backend on both sides, its 2-layer prefix drafting; 8 of phase 10's
    requests, half stochastic.  Tokens equal the plain recurrent engine's;
    the stash's bytes and the rollbacks' time (replays and pastes, CUDA
    synchronised) a round."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecEngine
    tag, k = "[serve-spec] (d)", SPEC_K
    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                       remat=False), device="cuda")
    params = model.init(0)
    draft, dparams = prefix_draft(model, params, 2)
    max_batch, max_len = 8, 1024
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, size=20)                 # phase 10's warm-up draw
    lengths = np.linspace(16, 600, 2 * n_requests).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths][1::2]
    lengths = lengths[1::2]
    samp = spec_samplings(n_requests)
    witness = serve_run(ServeEngine(model, params, max_batch, max_len), prompts, samp, max_new)
    eng = SpecEngine(model, params, draft, dparams, max_batch, max_len, spec_k=k)
    run = serve_run(eng, prompts, samp, max_new, time_rollbacks=True)
    snap = run["snap"]
    if eng.backend.name != "recurrent" or eng.draft_backend.name != "recurrent":
        raise AssertionError(f"{tag} backends {eng.backend.name}, {eng.draft_backend.name}")
    if run["tokens"] != witness["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(run["tokens"], witness["tokens"])) if a != b]
        raise AssertionError(f"{tag} requests {bad} differ from the recurrent engine's tokens")
    tgt = unsplit_launches(model, params, prompts[0], max_batch, max_len)
    drf = unsplit_launches(draft, dparams, prompts[0], max_batch, max_len)
    rounds = len(run["reports"])
    rt, rd = eng.backend.replay_steps, eng.draft_backend.replay_steps
    check_launches(run["counts"], spec_want(eng, run["work"], tgt, drf),
                   f"{tag} run, work {run['work']}, replays {rt} and {rd}")
    log(f"{tag} rwkv6-1.6b {cfg.n_layers} layers bf16, recurrent backend on both sides, draft "
        f"its {draft.cfg.n_layers}-layer prefix, {n_requests} requests ({lengths.min()}-"
        f"{lengths.max()} prompt tokens, half stochastic): tokens bit-equal to the recurrent "
        f"plain engine's; {spec_summary(run, k)}")
    log(f"{tag} stash a round: target {eng.backend.stash_bytes} B + draft "
        f"{eng.draft_backend.stash_bytes} B (device clones); rollbacks "
        f"{run['rollback_s'] * 1e3 / max(1, rounds):.3f} ms a round (replays of {rt} target and "
        f"{rd} draft steps in {rounds} rounds, and the pastes; each rollback synchronised, "
        f"which also slows the run's tok/s); the plain witness: {plain_summary(witness)}; "
        f"launches {nonzero(run['counts'])}")
    del eng
    check_spec_kernels(tag, "spec_rwkv", results,
                       lambda: SpecEngine(model, params, draft, dparams, max_batch, max_len,
                                          spec_k=k),
                       prompts, samp, tgt, drf)
    return {n: total.get(n, 0) + c for n, c in run["counts"].items()}


def phase_serve_recurrent(results: dict, arch: str, path: str, n_requests: int = 16,
                          max_new: int = 32) -> None:
    """``arch`` (rwkv6-1.6b or zamba2-7b) at its published widths and depth,
    bf16, random weights from seed 0, served over the recurrent backend with
    the dense serve phase's engine and traffic: max_batch 8, max_len 1024,
    16 greedy requests of 16-600 prompt tokens, max_new 32, each prefilled
    alone at its exact length; after 6 decode steps the most recently
    admitted lane is preempted and later resumes from its snapshot.  The
    run's launches must be those of its prefill dispatches and decode steps
    (``recurrent_launches``), and the restored lane bit-equal to its
    snapshot (compared after the timed window).  Then each kernel of the
    path is held against its plain version at the shapes the path serves
    (``check_served_kernels``)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.backends import lane_leaves
    from repro_torch.serving.engine import ServeEngine
    tag = f"[serve-{path}]"
    cfg = get_config(arch)
    model = build_model(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                       remat=False), device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"{tag} {arch} {cfg.n_layers} layers d_model {cfg.d_model}: {n_params} params "
        f"({n_params * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    per_prefill, per_step = recurrent_launches(cfg)
    max_batch, max_len = 8, 1024
    eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len)
    backend = eng.backend
    if backend.name != "recurrent":
        raise AssertionError(f"{tag}: the engine picked {backend.name} lanes")
    restored = []    # (snapshot, the lane's device copy just after it) of every restore
    restore = backend.restore

    def recorded_restore(slot, snap):
        ok = restore(slot, snap)
        restored.append((snap, {k: t.clone() for k, t in lane_leaves(backend.cache,
                                                                      slot).items()}))
        return ok

    backend.restore = recorded_restore
    rng = np.random.default_rng(0)
    with torch.no_grad():
        eng.submit(rng.integers(0, cfg.vocab_size, size=20), max_new=4)      # warm-up
        eng.run_until_drained()
        torch.cuda.synchronize()
        eng.reset_stats()
        lengths = np.linspace(16, 600, n_requests).astype(int)
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new=max_new)
        for _ in range(6):
            eng.step()
        victim = max((i for i, r in enumerate(eng.slots) if r is not None),
                     key=lambda i: (eng.slots[i].admitted_t, eng.slots[i].rid))
        eng.preempt(victim)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    del backend.restore    # the class's method again, and no cycle through the lanes
    restores = [all(torch.equal(lane[k].cpu(), snap[k]) for k in snap)
                for snap, lane in restored]
    copy_bytes = sum(t.numel() * t.element_size() for _, lane in restored
                     for t in lane.values())
    del restored
    snap = eng.metrics_snapshot()
    if len(done) != n_requests or any(len(r.out_tokens) != max_new for r in done):
        raise AssertionError(f"{tag}: {len(done)}/{n_requests} requests finished with "
                             f"{[len(r.out_tokens) for r in done]} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError(f"{tag}: a generated token lies outside the vocabulary")
    if (snap.prefill_dispatches != n_requests or snap.preemptions != 1 or snap.resumes < 1
            or not restores or not all(restores)):
        raise AssertionError(f"{tag}: {snap.prefill_dispatches} prefill dispatches for "
                             f"{n_requests} requests, {snap.preemptions} preemptions, "
                             f"{snap.resumes} resumes, restores bit-equal {restores}")
    want = {k: per_prefill[k] * snap.prefill_dispatches + per_step[k] * eng.steps
            for k in counts}
    check_launches(counts, want, f"{tag} run of {snap.prefill_dispatches} prefill dispatches "
                                 f"and {eng.steps} decode steps")
    gen_tokens = sum(len(r.out_tokens) for r in done)
    lane_bytes = sum(t.numel() * t.element_size()
                     for t in lane_leaves(backend.cache, 0).values())
    log(f"{tag} {n_requests} requests, prompts {int(lengths.min())}-{int(lengths.max())} "
        f"tokens, max_new {max_new}, max_batch {max_batch}, max_len {max_len}: {gen_tokens} "
        f"tokens in {wall:.3f} s = {gen_tokens / wall:.1f} tok/s; "
        f"{snap.prefill_dispatches} prefill dispatches, {eng.steps} decode steps, "
        f"{snap.preemptions} preemption, {snap.resumes} resume by restore (bit-equal)")
    log(f"{tag} TTFT mean {snap.ttft.mean * 1e3:.1f} ms p95 {snap.ttft.p95 * 1e3:.1f} ms; "
        f"TPOT mean {snap.tpot.mean * 1e3:.2f} ms; peak device memory {peak / 2**30:.2f} GiB "
        f"(of which {copy_bytes / 2**30:.3f} GiB the restored lanes' copies the bit-equality "
        f"check keeps); state per lane {lane_bytes} B ({backend.state_units} elements); the "
        f"window holds the run alone, its restores' device copies (a few ms) aside")
    log(f"{tag} launches on the main path: {counts}")

    # per dispatch and per step, and the decode step's time at a full batch
    toks = np.zeros((max_batch, 1), np.int32)
    active = np.ones((max_batch,), bool)
    with torch.no_grad():
        ops.reset_launch_counts()
        model.prefill(params, {"tokens": torch.zeros((1, 37), dtype=torch.int64,
                                                     device=model.device)}, max_len)
        check_launches(ops.launch_counts(), per_prefill, f"{tag} prefill dispatch")
        ops.reset_launch_counts()
        logits = backend.step(params, toks, active)
        check_launches(ops.launch_counts(), per_step, f"{tag} decode step")
        if logits.shape[0] != max_batch or not torch.isfinite(logits).all():
            raise AssertionError(f"{tag}: decode logits {tuple(logits.shape)} not finite")
        step_ms = sync_time_ms([lambda: backend.step(params, toks, active)], iters=10, warmup=2)
        snaps_ms = sync_time_ms([lambda: backend.snapshot(1)], iters=5, warmup=1)
        one = backend.snapshot(1)
        restore_ms = sync_time_ms([lambda: restore(2, one)], iters=5, warmup=1)
    log(f"{tag} decode step at batch {max_batch}: {step_ms:.3f} ms; launches a prefill "
        f"dispatch {per_prefill}, a decode step {per_step}; snapshot {snaps_ms:.3f} ms, "
        f"restore {restore_ms:.3f} ms a lane (CUDA events, 5 calls)")

    # every kernel at the shapes this path serves: B=1 prefills of 37 tokens
    # and of the longest prompt, one decode step of the full batch over the
    # max_len span, each against its plain version on the same inputs
    long_prompt = torch.as_tensor(prompts[-1][None], device=model.device)

    def drive():
        for toks_in in (long_prompt[:, :37], long_prompt):
            model.prefill(params, {"tokens": toks_in}, max_len)
        backend.step(params, toks, active)
    with torch.no_grad():
        served = check_served_kernels(tag, drive, {k: 2 * per_prefill[k] + per_step[k]
                                                   for k in per_prefill})
    log(f"{tag} kernels at the served shapes (B=1 prefills of 37 and "
        f"{long_prompt.shape[1]} tokens, a decode step of {max_batch} lanes over {max_len} "
        f"positions) against their plain versions, worst margin (error / limit): "
        + "; ".join(f"{k} {v['calls']} calls, first two inputs {v['shapes']}, "
                    f"{v['margin']:.3f}" for k, v in served.items()))
    for name, rec in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})[path] = dict(
            rec, shapes=[[list(d) for d in s] for s in rec["shapes"]])
    with torch.no_grad():
        profile_step(lambda: backend.step(params, toks, active),
                     f"{arch} decode step, batch {max_batch}")
        profile_step(lambda: model.prefill(params, {"tokens": long_prompt}, max_len),
                     f"{arch} prefill dispatch, 1 x {long_prompt.shape[1]} tokens")
    add_launches(results, counts, path)


# ---------------------------------------------------------------------------
# phases 19-22: the other families (MoE, enc-dec, vlm, the dense configs)
# ---------------------------------------------------------------------------

# the archs this slice brings, and the pure-SSM family (no registry config)
FAMILY_ARCHS = ("whisper-small", "internvl2-1b", "llama4-scout-17b-a16e", "grok-1-314b",
                "command-r-35b", "mistral-nemo-12b", "yi-34b", "pure-ssm")


def family_config(arch: str):
    """``arch``'s published config; "pure-ssm" is zamba2-7b's Mamba2 layers
    alone (family ssm, no shared block)."""
    from repro_torch.configs import get_config
    if arch == "pure-ssm":
        return dataclasses.replace(get_config("zamba2-7b"), arch_id="pure-ssm", family="ssm",
                                   attn_every=0)
    return get_config(arch)


def family_inputs(cfg, n: int, seed: int = 0) -> list:
    """Per-request model inputs beside the prompt, from ``FrontendPipeline``:
    whisper's frames, internvl2's frontend rows (numpy (P, D) each), else
    none."""
    from repro_torch.data.synthetic import DataConfig, FrontendPipeline
    if not cfg.frontend:
        return [{} for _ in range(n)]
    key = "frames" if cfg.family == "audio" else "frontend"
    rows = FrontendPipeline(DataConfig(cfg.vocab_size, 2, n, seed), cfg.frontend_seq,
                            cfg.d_model, key=key).batch(0)[key]
    return [{key: r} for r in rows]


def family_launches(cfg) -> tuple:
    """Launches of one prefill dispatch and of one decode step of a dense,
    MoE, vlm or encoder-decoder model, by kernel: flash once a layer's
    self-attention (and, in whisper, once each encoder layer and each
    decoder layer's cross-attention); the decode kernel once a layer's
    self-attention (whisper: and its cross-attention) in a decode step, or
    the paged kernel over a pool; RMSNorm twice a layer and once at the end
    (whisper: the encoder's two a layer and its final norm, the decoder's
    three a layer and its final norm)."""
    from repro_torch.kernels import ops
    zero = dict.fromkeys(ops.launch_counts(), 0)
    n = cfg.n_layers
    if cfg.n_enc_layers:
        e = cfg.n_enc_layers
        return (dict(zero, flash_attention=e + 2 * n, rmsnorm=2 * e + 1 + 3 * n + 1),
                dict(zero, decode_attention=2 * n, rmsnorm=3 * n + 1))
    return (dict(zero, flash_attention=n, rmsnorm=2 * n + 1),
            dict(zero, decode_attention=n, rmsnorm=2 * n + 1))


def paged_launches(per_step: dict) -> dict:
    """A decode step's launches over a block pool: the paged kernel in the
    dense decode kernel's place."""
    return dict(per_step, decode_attention=0, paged_decode_attention=per_step["decode_attention"])


class MoeRecorder:
    """Wraps ``models.moe.apply_moe`` while active: each call's routing is
    recorded (top-k picks, kept picks, the smallest gap between a token's
    k-th and (k+1)-th probability) and, with ``check``, its output is held
    to ``apply_moe_plain`` on the same input and the same routing (bf16
    within BF16_TOL x max(1, |ref|), fp32 within MODEL_TOL x max(1,
    |ref|)), the plain version's own routing found equal."""

    def __init__(self, check: bool):
        self.check = check
        self.calls, self.margin, self.gap = 0, 0.0, float("inf")
        self.picks, self.kept, self.tokens = 0, 0, 0
        self.routes = []

    def __enter__(self):
        from repro_torch.models import moe as tmoe
        self.real = real = tmoe.apply_moe

        def recorded(params, cfg, x, capacity_factor=1.25, group_size=4096, rt=None):
            g, n = tmoe.groups(x.shape[0] * x.shape[1], group_size)
            rt = tmoe.route(params, cfg, x.reshape(g, n, x.shape[-1]), capacity_factor)
            y, aux = real(params, cfg, x, capacity_factor, group_size, rt=rt)
            top = torch.topk(rt.probs, min(cfg.top_k + 1, cfg.n_experts), dim=-1).values
            if top.shape[-1] > cfg.top_k:
                self.gap = min(self.gap, (top[..., cfg.top_k - 1] - top[..., cfg.top_k])
                               .min().item())
            self.routes.append((rt.mask.cpu(), rt.keep.cpu()))
            self.picks += int(rt.mask.sum())
            self.kept += int(rt.keep.sum())
            self.tokens += g * n
            if self.check:
                own = tmoe.route(params, cfg, x.reshape(g, n, x.shape[-1]), capacity_factor)
                if not (torch.equal(own.mask, rt.mask) and torch.equal(own.keep, rt.keep)):
                    raise AssertionError("apply_moe_plain's routing differs on the same input")
                yp, _ = tmoe.apply_moe_plain(params, cfg, x, capacity_factor, group_size,
                                             rt=rt)
                tol = BF16_TOL if x.dtype == torch.bfloat16 else MODEL_TOL
                self.margin = max(self.margin, gate(y, yp, tol, True))
                if not torch.isfinite(y).all() or self.margin > 1.0:
                    raise AssertionError(f"MoE layer call {self.calls}: apply_moe vs "
                                         f"apply_moe_plain margin {self.margin:.3f}")
            self.calls += 1
            return y, aux

        tmoe.apply_moe = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe.apply_moe = self.real
        return False

    def summary(self) -> str:
        return (f"{self.calls} MoE calls, {self.tokens} tokens, {self.picks} top-k picks, "
                f"{self.kept} kept ({self.picks - self.kept} dropped at capacity), smallest "
                f"top-k probability gap {self.gap:.3e}"
                + (f", worst margin vs apply_moe_plain {self.margin:.3f}" if self.check else ""))


def family_parity(arch: str, n_layers: int = 4) -> None:
    """Reduced ``arch`` (``n_layers`` layers, fp32) on the card against the
    same weights on the CPU: prefill of two prompts (with whisper's frames
    or internvl2's rows) and 4 greedy decode steps, logits within MODEL_TOL
    (x max(1, |ref|) for the recurrent pure SSM) and the same argmax;
    greedy ServeEngine tokens identical (5 requests on 2 lanes, each with
    its inputs); for MoE every routing call's top-k picks and kept mask
    identical, the smallest top-k probability gap printed beside them."""
    from repro_torch.configs import RunConfig, reduced_config
    from repro_torch.convert import move_params
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeEngine
    tag = f"[parity] {arch}"
    cfg = dataclasses.replace(reduced_config(family_config(arch)), n_layers=n_layers)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    cpu, gpu = build_model(cfg, rcfg, device="cpu"), build_model(cfg, rcfg, device="cuda")
    p_cpu = cpu.init(0)
    p_gpu = move_params(p_cpu, "cuda")
    rng = np.random.default_rng(3)
    v, max_len = cfg.vocab_size, 64
    inputs = family_inputs(cfg, 2, seed=1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, v, size=(2, 20)))}
    batch.update({k: torch.as_tensor(np.stack([i[k] for i in inputs])) for k in inputs[0]})
    relative = cfg.family in ("ssm",)
    worst = 0.0
    recs = {}
    with torch.no_grad():
        for dev, model, params in (("cpu", cpu, p_cpu), ("cuda", gpu, p_gpu)):
            with MoeRecorder(check=False) as rec:
                b = {k: t.to(model.device) for k, t in batch.items()}
                logits, cache = model.prefill(params, b, max_len)
                out = [logits.cpu()]
                for _ in range(4):
                    nxt = torch.argmax(out[-1][:, :v], -1)[:, None]
                    logits, cache = model.decode_step(params, cache, nxt.to(model.device))
                    out.append(logits.cpu())
            recs[dev] = (rec, out)
        (rc, lc), (rg, lg) = recs["cpu"], recs["cuda"]
        for i, (a, b) in enumerate(zip(lg, lc)):
            worst = max(worst, check_close(f"{tag} logits {i}", a[:, :v], b[:, :v], MODEL_TOL,
                                           relative))
            if not torch.equal(torch.argmax(a[:, :v], -1), torch.argmax(b[:, :v], -1)):
                raise AssertionError(f"{tag} step {i}: card and CPU argmax differ")
        if len(rg.routes) != len(rc.routes) or any(
                not (torch.equal(mg, mc) and torch.equal(kg, kc))
                for (mg, kg), (mc, kc) in zip(rg.routes, rc.routes)):
            raise AssertionError(f"{tag}: expert picks or kept masks differ card vs CPU")
        prompts = [rng.integers(0, v, size=n) for n in (5, 17, 33, 9, 12)]
        per_req = family_inputs(cfg, len(prompts), seed=2)
        served = {}
        for dev, model, params in (("cpu", cpu, p_cpu), ("cuda", gpu, p_gpu)):
            eng = ServeEngine(model, params, max_batch=2, max_len=max_len)
            for p, ex in zip(prompts, per_req):
                eng.submit(p, max_new=8, **ex)
            served[dev] = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        lanes = eng.backend.name
    if served["cuda"] != served["cpu"] or len(served["cuda"]) != len(prompts):
        raise AssertionError(f"{tag}: greedy tokens differ card vs CPU: {served}")
    moe = (f"; MoE: {rg.summary()}, picks and kept masks identical card vs CPU"
           if rg.calls else "")
    log(f"{tag} reduced, {n_layers} layers, fp32: logits card vs CPU max |err| {worst:.3e} "
        f"(tol {MODEL_TOL}{' x max(1, |ref|)' if relative else ''}); greedy tokens identical for "
        f"{len(prompts)} requests ({gpu.decode_state.kind} state, {lanes} lanes){moe}")


def family_model(arch: str, n_layers: int = 0):
    """``arch`` at its published widths (cut to ``n_layers`` where given),
    bf16, random weights from seed 0 drawn on the card: (model, params)."""
    from repro_torch.configs import RunConfig
    from repro_torch.convert import leaves
    from repro_torch.models.api import build_model
    cfg = family_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                       remat=False), device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    cut = f" (cut from {family_config(arch).n_layers})" if n_layers else ""
    log(f"[{arch}] {cfg.n_layers} layers{cut} d_model {cfg.d_model}: {n_params} params "
        f"({n_params * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def family_serve(tag: str, model, params, prompts, inputs, max_new: int, max_batch: int,
                 max_len: int, **engine_kw) -> dict:
    """Serve ``prompts`` (each with its ``inputs``) through a fresh
    ServeEngine after a warm-up request: tokens by prompt index, the run's launches,
    wall time, snapshot and engine.  Every request must finish with
    ``max_new`` tokens inside the vocabulary."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len, **engine_kw)
    v = model.cfg.vocab_size
    with torch.no_grad():
        eng.submit(prompts[0][:8], max_new=2, **inputs[0])              # warm-up
        eng.run_until_drained()
        torch.cuda.synchronize()
        eng.reset_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=max_new, **ex) for p, ex in zip(prompts, inputs)]
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    if len(done) != len(prompts) or any(len(r.out_tokens) != max_new for r in done):
        raise AssertionError(f"{tag}: {len(done)}/{len(prompts)} requests finished with "
                             f"{[len(r.out_tokens) for r in done]} tokens")
    if any(not 0 <= t < v for r in done for t in r.out_tokens):
        raise AssertionError(f"{tag}: a generated token lies outside the vocabulary")
    by_rid = {r.rid: r.out_tokens for r in done}
    return dict(tokens={i: by_rid[rid] for i, rid in enumerate(rids)}, counts=counts, wall=wall,
                snap=eng.metrics_snapshot(), eng=eng)


def lone_witness(model, params, prompts, inputs, max_new: int, max_batch: int,
                 max_len: int) -> dict:
    """Each request served alone (submitted and drained before the next) by
    one ServeEngine of the same lanes: the same prefill (one request at its
    exact length) and the same decode shapes as a shared run, so a lane's
    tokens are bit-equal to its shared run's wherever lanes do not couple.
    Tokens by prompt index."""
    from repro_torch.serving.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=max_batch, max_len=max_len)
    out = {}
    with torch.no_grad():
        for rid, (p, ex) in enumerate(zip(prompts, inputs)):
            eng.submit(p, max_new=max_new, **ex)
            out[rid] = eng.run_until_drained()[-1].out_tokens
    return out


def report_run(tag: str, run: dict, prompts, max_new: int, max_batch: int, max_len: int,
               per_prefill: dict, per_step: dict) -> None:
    """The run's launches held to its prefill dispatches' and decode steps'
    (``family_launches``), and its tok/s, TTFT and TPOT logged."""
    snap, eng, counts = run["snap"], run["eng"], run["counts"]
    want = {k: per_prefill[k] * snap.prefill_dispatches + per_step[k] * eng.steps
            for k in counts}
    check_launches(counts, want, f"{tag} run of {snap.prefill_dispatches} prefill dispatches "
                                 f"and {eng.steps} decode steps")
    n = sum(len(t) for t in run["tokens"].values())
    lengths = [len(p) for p in prompts]
    log(f"{tag} {len(prompts)} requests, prompts {min(lengths)}-{max(lengths)} tokens, max_new "
        f"{max_new}, max_batch {max_batch}, max_len {max_len}, {eng.backend.name} lanes: {n} "
        f"tokens in {run['wall']:.3f} s = {n / run['wall']:.1f} tok/s; "
        f"{snap.prefill_dispatches} prefill dispatches, {eng.steps} decode steps; TTFT mean "
        f"{snap.ttft.mean * 1e3:.1f} ms p95 {snap.ttft.p95 * 1e3:.1f} ms, TPOT mean "
        f"{snap.tpot.mean * 1e3:.2f} ms; launches {nonzero(counts)} = a prefill dispatch "
        f"{nonzero(per_prefill)} x {snap.prefill_dispatches} + a decode step "
        f"{nonzero(per_step)} x {eng.steps}")


def served_kernels(results: dict, tag: str, path: str, model, params, eng, batch: dict,
                   max_len: int, per_prefill: dict, per_step: dict, moe: bool = False) -> None:
    """``check_served_kernels`` over a B=1 prefill of ``batch`` and 3 decode
    steps of every lane of ``eng`` (and, with ``moe``, every MoE layer of
    them held to ``apply_moe_plain``); the result under each kernel's
    ``served_shapes``."""
    toks = np.zeros((eng.max_batch, 1), np.int32)
    active = np.ones((eng.max_batch,), bool)

    def drive():
        model.prefill(params, batch, max_len)
        for _ in range(3):
            eng.backend.step(params, toks, active)
    want = {k: per_prefill[k] + 3 * per_step[k] for k in per_prefill}
    with torch.no_grad(), MoeRecorder(check=True) as rec:
        served = check_served_kernels(tag, drive, want)
    if moe and not rec.calls:
        raise AssertionError(f"{tag}: no MoE layer ran")
    log(f"{tag} kernels at the served shapes against their plain versions, worst margin "
        f"(error / limit): " + "; ".join(f"{k} {v['calls']} calls, first two inputs "
                                         f"{v['shapes'][:3]}, {v['margin']:.3f}"
                                         for k, v in served.items())
        + (f"; {rec.summary()}" if moe else ""))
    for name, r in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})[path] = dict(
            r, shapes=[[list(d) for d in s] for s in r["shapes"]])


def phase_serve_moe(results: dict) -> None:
    """(a) llama4-scout-17b-a16e at full width cut to 12 of its 48 layers,
    bf16, over dense lanes (chunked-local attention is not poolable):
    max_batch 8, max_len 9216, 16 greedy requests of 16-600 tokens and one
    of 9000 (past the 8192 chunk: the ring and the chunk mask both run),
    max_new 16, each prefilled alone at its exact length (MoE takes no
    padded prefill); (b) grok-1-314b at full width cut to 4 of its 64
    layers over the paged pool (max_batch 16, 1024 16-token blocks, no
    preemption), 16 requests of 16-600 tokens, max_new 16.  Each: exact
    launches, a second seeded run's tokens equal (lanes share expert
    capacity at a decode step, so a lone-request witness would differ: the
    rerun is the witness), each kernel against its plain version and every
    MoE layer against ``apply_moe_plain`` at the served shapes (the longest
    prefill and 3 decode steps)."""
    from repro_torch.serving.engine import EngineConfig
    rng = np.random.default_rng(11)
    for arch, n_layers, path in (("llama4-scout-17b-a16e", 12, "moe llama4"),
                                 ("grok-1-314b", 4, "moe grok")):
        tag = f"[serve-moe] {arch}"
        t_phase = time.perf_counter()
        model, params = family_model(arch, n_layers)
        cfg = model.cfg
        llama = cfg.attention == "chunked_local"
        max_new = 16
        if llama:
            max_batch, max_len, kw = 8, 9216, {}
            lengths = list(np.linspace(16, 600, 15).astype(int)) + [9000]
        else:
            max_batch, max_len = 16, 1024
            kw = dict(config=EngineConfig(kv_blocks=max_batch * max_len // 16,
                                          kv_block_size=16))
            lengths = list(np.linspace(16, 600, 16).astype(int))
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lengths]
        inputs = [{} for _ in prompts]
        per_prefill, per_step = family_launches(cfg)
        if not llama:
            per_step = paged_launches(per_step)
        run = family_serve(tag, model, params, prompts, inputs, max_new, max_batch, max_len,
                           **kw)
        if run["eng"].backend.name != ("dense" if llama else "paged"):
            raise AssertionError(f"{tag}: served over {run['eng'].backend.name} lanes")
        report_run(tag, run, prompts, max_new, max_batch, max_len, per_prefill, per_step)
        again = family_serve(tag, model, params, prompts, inputs, max_new, max_batch, max_len,
                             **kw)
        if again["tokens"] != run["tokens"]:
            raise AssertionError(f"{tag}: a seeded rerun's tokens differ")
        log(f"{tag} seeded rerun: tokens equal ({again['wall']:.3f} s)")
        eng = run["eng"]
        toks = np.zeros((max_batch, 1), np.int32)
        active = np.ones((max_batch,), bool)
        long = {"tokens": torch.as_tensor(prompts[-1][None], device=model.device)}
        served_kernels(results, tag, path, model, params, eng, long, max_len, per_prefill,
                       per_step, moe=True)
        with torch.no_grad():
            profile_step(lambda: eng.backend.step(params, toks, active),
                         f"{arch} decode step, batch {max_batch}")
        add_launches(results, run["counts"], path)
        del model, params, eng, run, again
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{tag} phase part {time.perf_counter() - t_phase:.1f} s")


def phase_serve_family(results: dict, arch: str, path: str, max_batch: int, max_len: int,
                       lengths, max_new: int = 32) -> None:
    """``arch`` (whisper-small or internvl2-1b) at its published widths and
    depth, bf16, over dense lanes: 16 greedy requests with their frames or
    1024 frontend rows from ``FrontendPipeline``, each prefilled alone at
    its exact length; exact launches; every request's tokens bit-equal to
    a lone-request witness's; each kernel against its plain version at the
    served shapes (a prefill of the longest prompt and 3 decode steps)."""
    tag = f"[serve-{path}] {arch}"
    model, params = family_model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lengths]
    inputs = family_inputs(cfg, len(prompts), seed=3)
    per_prefill, per_step = family_launches(cfg)
    run = family_serve(tag, model, params, prompts, inputs, max_new, max_batch, max_len)
    if run["eng"].backend.name != "dense" or run["snap"].prefill_dispatches != len(prompts):
        raise AssertionError(f"{tag}: {run['eng'].backend.name} lanes, "
                             f"{run['snap'].prefill_dispatches} prefill dispatches")
    report_run(tag, run, prompts, max_new, max_batch, max_len, per_prefill, per_step)
    t0 = time.perf_counter()
    witness = lone_witness(model, params, prompts, inputs, max_new, max_batch, max_len)
    if witness != run["tokens"]:
        bad = [rid for rid in witness if witness[rid] != run["tokens"][rid]]
        raise AssertionError(f"{tag}: requests {bad} differ from their lone-request witnesses")
    log(f"{tag} every request's tokens bit-equal to its lone-request witness's "
        f"({time.perf_counter() - t0:.1f} s)")
    eng = run["eng"]
    toks = np.zeros((max_batch, 1), np.int32)
    active = np.ones((max_batch,), bool)
    longest = int(np.argmax(lengths))
    b = {"tokens": torch.as_tensor(prompts[longest][None], device=model.device)}
    b.update({k: torch.as_tensor(v[None], device=model.device)
              for k, v in inputs[longest].items()})
    served_kernels(results, tag, path, model, params, eng, b, max_len, per_prefill, per_step)
    with torch.no_grad():
        profile_step(lambda: eng.backend.step(params, toks, active),
                     f"{arch} decode step, batch {max_batch}")
        profile_step(lambda: model.prefill(params, b, max_len),
                     f"{arch} prefill dispatch, 1 x {lengths[longest]} tokens"
                     + (" + 1024 rows" if "frontend" in b else " + 1500 frames"))
    add_launches(results, run["counts"], path)


def phase_serve_dense_configs(results: dict) -> None:
    """mistral-nemo-12b at full width and depth (40 layers, q_dim 4096 !=
    d_model 5120), bf16: 16 requests of 16-600 tokens, max_new 32, over
    bucketed dense lanes (max_batch 8, max_len 1024) and over the paged
    pool (max_batch 16, 1024 16-token blocks); exact launches in both, the
    paged run's agreement with the dense run printed, each kernel against
    its plain version at the served shapes."""
    from repro_torch.serving.engine import EngineConfig
    arch = "mistral-nemo-12b"
    model, params = family_model(arch)
    cfg = model.cfg
    if cfg.q_dim == cfg.d_model:
        raise AssertionError(f"{arch}: q_dim {cfg.q_dim} equals d_model")
    rng = np.random.default_rng(13)
    lengths = np.linspace(16, 600, 16).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lengths]
    inputs = [{} for _ in prompts]
    per_prefill, per_step = family_launches(cfg)
    runs = {}
    for layout, max_batch, kw in (("dense", 8, {}),
                                  ("paged", 16, dict(config=EngineConfig(kv_blocks=1024,
                                                                         kv_block_size=16)))):
        tag = f"[serve-dense-configs] {arch} {layout}"
        run = family_serve(tag, model, params, prompts, inputs, 32, max_batch, 1024, **kw)
        if run["eng"].backend.name != layout:
            raise AssertionError(f"{tag}: served over {run['eng'].backend.name} lanes")
        step = per_step if layout == "dense" else paged_launches(per_step)
        report_run(tag, run, prompts, 32, max_batch, 1024, per_prefill, step)
        runs[layout] = run
        long = {"tokens": torch.as_tensor(prompts[-1][None], device=model.device)}
        served_kernels(results, tag, f"{arch} {layout}", model, params, run["eng"], long, 1024,
                       per_prefill, step)
        add_launches(results, run["counts"], f"mistral {layout}")
    same = sum(runs["paged"]["tokens"][r] == runs["dense"]["tokens"][r] for r in
               runs["dense"]["tokens"])
    log(f"[serve-dense-configs] {arch}: {same} of {len(prompts)} requests' tokens equal over "
        f"paged and dense lanes (bf16: other kernels and batch shapes round apart)")
    with torch.no_grad():
        eng = runs["dense"]["eng"]
        toks = np.zeros((8, 1), np.int32)
        profile_step(lambda: eng.backend.step(params, toks, np.ones((8,), bool)),
                     f"{arch} decode step, batch 8")


# ---------------------------------------------------------------------------
# phase 17: the serving fleet (ServingFleet) on full-width granite-8b
# ---------------------------------------------------------------------------

FLEET_BATCH, FLEET_LEN, FLEET_BS = 4, 1024, 16
# the phone replica's pool: every lane's whole span (4 x 1024 / 16), so it
# never preempts and a lane it serves is decoded as the paged witness's is
FLEET_BLOCKS = FLEET_BATCH * FLEET_LEN // FLEET_BS
# the phone's throttle ramp in bench_fleet.py's shape (toward 6x, tau 0.15 s),
# from 1.0 sim s in (a) (once the phone has served its first requests) and
# from 0.5 s in (d), as the bench has it
FLEET_RAMP = (1.0, 6.0, 0.15)
AB_RAMP = (0.5, 6.0, 0.15)
# (a)'s arrivals span and its seeded crash of the host's window, in sim s: the
# host has finished requests of its own before it dies
FLEET_SPAN = 1.0
FLEET_CRASH = (1.2, 1.4)


def same_tree(a, b) -> bool:
    """Nested dicts, lists and numbers equal, NaN equal to NaN."""
    try:
        np.testing.assert_equal(a, b)
    except AssertionError:
        return False
    return True


def exact_lengths(eng, max_len: int) -> None:
    """Make a fleet's ServeEngine (or SpecEngine) prefill each request alone
    at its exact length (``exact_prefill``'s settings, applied after the
    fleet built it: the fleet passes its ``prefill_buckets`` to replicas
    only, and a prefill batch size to none)."""
    eng.buckets = tuple(range(1, max_len + 1))
    eng.max_prefill_batch = 1


def fleet_traffic(vocab: int, n: int = 24, seed: int = 5):
    """``n`` prompts of 16-600 tokens (seeded lengths and tokens), half
    stochastic (``spec_samplings``), arriving evenly over ``FLEET_SPAN``
    sim s."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 601, size=n)
    prompts = [rng.integers(0, vocab, size=int(t)) for t in lengths]
    return prompts, spec_samplings(n), np.linspace(0.0, FLEET_SPAN, n)


def full_fleet(model, params, draft, dparams, telemetry: str = "sim"):
    """(a)'s fleet: replica ``host`` (H100 profile, dense lanes), replica
    ``phone`` (iPhone 16, paged with the prefix cache), the stage group
    ``group`` (members ``g_host`` H100 and ``g_phone`` iPhone 11 Pro, the cut
    ``split_decode`` picks) and the spec pair ``spec`` (a 4-layer prefix
    drafting on ``s_draft``, an iPhone 16; the target on ``s_target``, an
    H100; k 3); ServingElasticPolicy on, the phone throttled by
    ``FLEET_RAMP``, a seeded crash of ``host`` and a partition of
    ``g_phone`` that heals before detection; every engine prefilling at
    exact lengths.  Also wraps each unit's stepping verb (see
    ``instrument_units``)."""
    from repro_torch.hw.specs import H100, IPHONE_11_PRO, IPHONE_16
    from repro_torch.runtime.elastic import ServingElasticPolicy
    from repro_torch.runtime.faults import KillEvent, KillTrace, make_kill_trace
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.fleet import (ServingFleet, SpecPair, StageGroup,
                                           ThrottleTrace, WorkerSpec)
    paged = EngineConfig(kv_blocks=FLEET_BLOCKS, kv_block_size=FLEET_BS, prefix_cache=True)
    workers = [WorkerSpec("host", H100, max_batch=FLEET_BATCH),
               WorkerSpec("phone", IPHONE_16, max_batch=FLEET_BATCH, engine_config=paged)]
    group = StageGroup("group", (WorkerSpec("g_host", H100), WorkerSpec("g_phone", IPHONE_11_PRO)),
                       max_batch=FLEET_BATCH)
    pair = SpecPair("spec", draft=WorkerSpec("s_draft", IPHONE_16),
                    target=WorkerSpec("s_target", H100), draft_model=draft,
                    draft_params=dparams, spec_k=SPEC_K, max_batch=FLEET_BATCH)
    crash = make_kill_trace(["host"], 1, t0_s=FLEET_CRASH[0], t1_s=FLEET_CRASH[1], seed=7)
    trace = KillTrace(events=tuple(crash) + (
        KillEvent(t_s=0.3, worker="g_phone", kind="partition", down_s=0.3),))
    fleet = ServingFleet(model, params, workers, groups=[group], spec_pairs=[pair],
                         max_len=FLEET_LEN, tick_s=0.05, policy=ServingElasticPolicy(),
                         throttle=ThrottleTrace({"phone": FLEET_RAMP}),
                         prefill_buckets=range(1, FLEET_LEN + 1), telemetry=telemetry,
                         kill_trace=trace)
    for u in (*fleet.workers, *fleet.spec_pairs):
        exact_lengths(u.engine, FLEET_LEN)
    return fleet


def instrument_units(fleet) -> dict:
    """Wrap each unit's stepping verb (a replica's ``step``, a group's or a
    spec pair's ``step_paced``) so that it runs inside a
    ``record_function("unit:<name>")`` span and records whether the card's
    stream was idle when it returned (a measured window that closes after a
    host sync finds it idle); installs ``count_spec_work`` on the spec
    engine.  Returns {"windows": {name: [idle, ...]}, "spec_work": ...}."""
    from torch.profiler import record_function
    rec = {"windows": {}, "spec_work": count_spec_work(fleet.spec_pairs[0].engine)}

    def wrap(eng, attr, name):
        fn = getattr(eng, attr)
        idle = rec["windows"].setdefault(name, [])

        def call(*a, **kw):
            with record_function(f"unit:{name}"):
                out = fn(*a, **kw)
            idle.append(torch.cuda.current_stream().query())
            return out
        setattr(eng, attr, call)
    for w in fleet.workers:
        wrap(w.engine, "step", w.name)
    for u in (*fleet.groups, *fleet.spec_pairs):
        wrap(u.engine, "step_paced", u.name)
    return rec


def drive_fleet(fleet, prompts, samplings, arrivals, max_new: int, on_tick=None) -> dict:
    """Submit each request when its arrival comes due on the fleet's sim
    clock and tick until drained (``drive_sim``); ``on_tick(i)`` is called
    before tick ``i``.  Tokens by rid, wall s (synchronised), ticks."""
    from repro_torch.serving.fleet import drive_sim
    tick = fleet.tick
    n = [0]

    def counted_tick():
        if on_tick is not None:
            on_tick(n[0])
        n[0] += 1
        tick()
    fleet.tick = counted_tick
    rids = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive_sim(fleet, arrivals, lambda i: rids.append(
            fleet.submit(prompts[i], max_new=max_new, sampling=samplings[i])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del fleet.tick    # the class's method again, and no cycle through the fleet
    if rids != list(range(len(prompts))):
        raise AssertionError(f"fleet admissions {rids}")
    return dict(tokens={rec.req.rid: list(rec.req.out_tokens) for rec in fleet.completed},
                wall=wall, ticks=n[0], snap=fleet.snapshot())


def units_want(fleets, launches: tuple) -> dict:
    """The launches by kernel that the replica workers and stage groups of
    ``fleets`` made: each engine's prefill dispatches and decode steps
    (paged lanes launch the paged kernel where dense ones launch the decode
    kernel; a stage path launches the unsplit model's); ``launches`` is the
    model's (prefill dispatch, decode step) launches."""
    per_prefill, per_step = launches
    paged_step = {**per_step, "decode_attention": 0,
                  "paged_decode_attention": per_step["decode_attention"]}
    want = dict.fromkeys(per_prefill, 0)

    def add(n_prefill, n_steps, step):
        for k in want:
            want[k] += per_prefill[k] * n_prefill + step[k] * n_steps
    for fleet in fleets:
        for w in fleet.workers:
            paged = w.engine.backend.name == "paged"
            add(w.engine.metrics.prefill_dispatches, w.engine.steps,
                paged_step if paged else per_step)
        for grp in fleet.groups:
            g = grp.engine.metrics_snapshot()
            add(g.prefill_dispatches, g.steps, per_step)
    return want


def fleet_want(fleet, rec: dict, dense: tuple, draft: tuple) -> dict:
    """The launches by kernel a fleet's run must have made: its replicas'
    and group's (``units_want``) and the spec pair's ``spec_want``;
    ``dense`` and ``draft`` are the target's and the draft's (prefill,
    decode step) launches."""
    want = units_want([fleet], dense)
    s = fleet.spec_pairs[0].engine
    for k, n in spec_want(s, rec["spec_work"], dense, draft).items():
        want[k] += n
    return want


def first_diff_margin(model, params, prompt, got: list, want: list,
                      max_len: int = FLEET_LEN) -> tuple:
    """(position, the witness's token, the fleet's, their logit margin): the
    first token where ``got`` leaves ``want``, and the witness's logit of
    its token less its logit of the fleet's token, from an exact-length
    prefill of the prompt and the witness's tokens before it."""
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ctx = np.concatenate([np.asarray(prompt), np.asarray(want[:j], np.int64)])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(ctx[None],
                                                                       device=model.device)},
                                  max_len)
    row = logits[0].float()
    return j, want[j], got[j], float(row[want[j]] - row[got[j]])


def phase_serve_fleet(results: dict, model, params, n_requests: int = 24,
                      max_new: int = 32) -> None:
    """The serving fleet on one card, in four parts.  (a) granite-8b at full
    width and depth, bf16, one set of weights for every unit
    (``full_fleet``): 24 requests of 16-600 prompt tokens, half stochastic;
    every request completes, the trace's one death and its resurrections,
    a migration, no paged block left after the drain, exact launches, each
    kernel against its plain version at the fleet's shapes, a second run
    equal snapshot for snapshot and token for token, and every request
    never migrated nor resurrected bit-equal to an exact-length witness
    engine of its unit's kind (dense, or paged like the phone).  (b)
    ``fleet_fp32``: the reference's fp32 identity claims.  (c) (a)'s fleet
    under ``telemetry="wall"``: the readings the monitor got beside the
    device time of the same steps, and every measured window closing on an
    idle stream.  (d) bench_fleet.py's A/B, policies on against off."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from torch.profiler import ProfilerActivity, profile
    tag = "[serve-fleet]"
    cfg = model.cfg
    draft, dparams = prefix_draft(model, params, 4)
    prompts, samp, arrivals = fleet_traffic(cfg.vocab_size, n_requests)
    lengths = [len(p) for p in prompts]

    # (a) the fleet, launches zeroed just before and read just after
    fleet = full_fleet(model, params, draft, dparams)
    g = fleet.groups[0]
    log(f"{tag} (a) split_decode's cut for [H100, iPhone 11 Pro]: {g.engine.cuts} (stage param "
        f"bytes {list(g.engine.stage_param_bytes)}); units host, phone, group, spec")
    rec = instrument_units(fleet)
    # ticks ``window`` are timed here (a synchronize at each end) and traced
    # in the second run below: the device time the trace reads over the
    # host wall of the same ticks untraced is the busy share (the profiler
    # slows the host several times over, so its own wall would understate it)
    window, stamps = (10, 20), {}

    def stamp(i):
        if i in window:
            torch.cuda.synchronize()
            stamps[i] = time.perf_counter()
    ops.reset_launch_counts()
    run = drive_fleet(fleet, prompts, samp, arrivals, max_new, on_tick=stamp)
    counts = ops.launch_counts()
    snap = run["snap"]
    dense = unsplit_launches(model, params, prompts[0], FLEET_BATCH, FLEET_LEN)
    drf = unsplit_launches(draft, dparams, prompts[0], FLEET_BATCH, FLEET_LEN)
    kinds = [k for _, k, _ in fleet.failure_log]
    if (snap.completed != n_requests or snap.orphaned or snap.deaths != 1
            or snap.dead_units != ("host",) or snap.resurrections < 1
            or snap.resurrections != kinds.count("resurrect")
            or "return:partition" not in kinds or snap.migrations < 1
            or any(len(t) != max_new for t in run["tokens"].values())):
        raise AssertionError(f"{tag} (a) completed {snap.completed}/{n_requests}, orphaned "
                             f"{snap.orphaned}, deaths {snap.deaths} {snap.dead_units}, "
                             f"resurrections {snap.resurrections}, migrations "
                             f"{snap.migrations}, log {fleet.failure_log}")
    leaked = {w.name: w.engine.backend.blocks_in_use for w in fleet.workers
              if w.engine.backend.name == "paged" and w.engine.backend.blocks_in_use}
    if leaked:
        raise AssertionError(f"{tag} (a) paged blocks in use after the drain: {leaked}")
    check_launches(counts, fleet_want(fleet, rec, dense, drf), f"{tag} (a) fleet run")
    not_idle = {n: w.count(False) for n, w in rec["windows"].items() if not all(w)}
    moved = {r.req.rid for r in fleet.completed if r.migrated}
    where = {r.req.rid: r.worker for r in fleet.completed}
    per_unit = {u: sum(1 for r in fleet.completed if r.worker == u)
                for u in ("host", "phone", "group", "spec")}
    log(f"{tag} (a) granite-8b {cfg.n_layers} layers bf16, {n_requests} requests "
        f"({min(lengths)}-{max(lengths)} prompt tokens, max_new {max_new}, 12 greedy, 12 "
        f"stochastic) over {arrivals[-1]:.1f} sim s: completed {snap.completed}, finished by "
        f"unit {per_unit}; sim {snap.sim_t:.2f} s in {run['ticks']} ticks, goodput "
        f"{snap.goodput_tokens_per_s:.1f} tok per sim s; migrations {snap.migrations} "
        f"({snap.migrated_requests} requests moved, {snap.queue_moves} queue moves), drains "
        f"{snap.drains}, deaths {snap.deaths} {snap.dead_units}, resurrections "
        f"{snap.resurrections} (recompute {snap.recompute_tokens} tokens), checkpoints "
        f"{snap.checkpoints}, orphaned {snap.orphaned}; failure log {fleet.failure_log}")
    log(f"{tag} (a) host wall {run['wall']:.3f} s = {run['wall'] / run['ticks'] * 1e3:.2f} ms a "
        f"tick; launches {nonzero(counts)} = {sum(counts.values()) / run['ticks']:.1f} a tick, "
        f"exactly each unit's prefill dispatches and steps; windows closing on a busy stream "
        f"{not_idle or 'none'}")
    log(f"{tag} (a) wire: group frames {snap.per_group['group'].frames_sent}, "
        f"{snap.per_group['group'].frame_bytes} B ({snap.per_group['group'].transfer_s:.4f} sim "
        f"s on the link, {snap.per_group['group'].link_stall_ticks} ticks in flight); spec pair "
        f"{snap.per_spec['spec'].frame_bytes} B ({snap.per_spec['spec'].rounds_run} rounds, "
        f"acceptance {snap.per_spec['spec'].engine.spec_acceptance_rate:.4f}, colocations "
        f"{snap.per_spec['spec'].colocations}); phone: "
        f"{snap.per_worker['phone'].engine.kv_blocks_peak} "
        f"blocks peak, {snap.per_worker['phone'].engine.prefill_skipped} full hits, state "
        f"occupancy {snap.per_worker['phone'].state_occupancy}")
    add_launches(results, counts, "fleet")

    # the witnesses: every request alone at its exact length, max_batch 4,
    # over dense lanes and over the phone's paged pool
    witness = {}
    for kind, config in (("dense", None),
                         ("paged", EngineConfig(kv_blocks=FLEET_BLOCKS, kv_block_size=FLEET_BS,
                                                prefix_cache=True))):
        eng = ServeEngine(model, params, FLEET_BATCH, FLEET_LEN, config=config,
                          **exact_prefill(FLEET_LEN))
        with torch.no_grad():
            rids = [eng.submit(p, max_new=max_new, sampling=s) for p, s in zip(prompts, samp)]
            done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        witness[kind] = [done[r] for r in rids]
        del eng
    stayed = [i for i in range(n_requests) if i not in moved]
    bad = [i for i in stayed
           if run["tokens"][i] != witness["paged" if where[i] == "phone" else "dense"][i]]
    if bad:
        raise AssertionError(f"{tag} (a) requests {bad} (never migrated nor resurrected, served "
                             f"by {[where[i] for i in bad]}) differ from the witness")
    same_moved, margins = 0, []
    for i in sorted(moved):
        want = witness["paged" if where[i] == "phone" else "dense"][i]
        if run["tokens"][i] == want:
            same_moved += 1
        else:
            margins.append((i, where[i], "greedy" if samp[i] is None else "stochastic",
                            *first_diff_margin(model, params, prompts[i], run["tokens"][i],
                                               want)))
    log(f"{tag} (a) {len(stayed)} requests never migrated nor resurrected: bit-equal to the "
        f"exact-length witness of their unit's kind; of the {len(moved)} migrated or "
        f"resurrected (re-prefilled over prompt and generated tokens, in bf16 another "
        f"computation than the decode steps that made them), {same_moved} equal the witness; "
        f"the others' first differing token (rid, unit, lane, position, witness token, fleet "
        f"token, the witness's logit margin between them): {margins}")

    # the same seeded fleet again: equal snapshot and tokens; its ticks
    # ``window`` traced (kernels only) for the device's busy share
    fleet2 = full_fleet(model, params, draft, dparams)
    state = {}

    def on_tick(i):
        if i in window:
            torch.cuda.synchronize()
            state[i] = time.perf_counter()
            if i == window[0]:
                state["prof"] = profile(activities=[ProfilerActivity.CUDA])
                state["prof"].__enter__()
            else:
                state["prof"].__exit__(None, None, None)
    run2 = drive_fleet(fleet2, prompts, samp, arrivals, max_new, on_tick=on_tick)
    busy_us = sum(e.self_device_time_total for e in state["prof"].key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    win_s = stamps[window[1]] - stamps[window[0]]
    traced_s = state[window[1]] - state[window[0]]
    if not same_tree(run2["snap"].as_dict(), snap.as_dict()) or run2["tokens"] != run["tokens"]:
        raise AssertionError(f"{tag} (a) a second run of the seeded fleet differs: snapshots "
                             f"equal {same_tree(run2['snap'].as_dict(), snap.as_dict())}, tokens "
                             f"equal {run2['tokens'] == run['tokens']}")
    log(f"{tag} (a) a second run of the same seeded fleet: FleetSnapshot.as_dict() and every "
        f"token equal; {run2['wall']:.3f} s host wall; ticks {window[0]}-{window[1] - 1}: "
        f"{win_s * 1e3:.1f} ms of host wall in the first run, {traced_s * 1e3:.1f} ms traced "
        f"(kernels) in this one, device busy {busy_us / 1e3:.1f} ms = "
        f"{100 * busy_us / 1e6 / win_s:.1f}% of the untraced wall")
    del fleet2

    # each kernel of the path against its plain version at the fleet's
    # shapes: a fresh fleet serving the two longest and two shortest requests
    order = np.argsort(lengths)
    pick = [int(i) for i in (*order[:2], *order[-2:])]
    made = []

    def drive():
        f = full_fleet(model, params, draft, dparams)
        made.append((f, instrument_units(f)))
        drive_fleet(f, [prompts[i] for i in pick], [samp[i] for i in pick],
                    np.zeros(len(pick)), 8)
    with torch.no_grad():
        served = check_served_kernels(f"{tag} (a)", drive,
                                      lambda: fleet_want(*made[0], dense, drf))
    log(f"{tag} (a) kernels at the fleet's shapes (requests of {[lengths[i] for i in pick]} "
        f"prompt tokens over every unit) against their plain versions, worst margin (error / "
        f"limit): " + "; ".join(f"{k} {v['calls']} calls, {v['margin']:.3f}"
                                for k, v in served.items()))
    for name, r in served.items():
        entry = results.setdefault(name, {"name": name})
        entry.setdefault("served_shapes", {})["fleet"] = dict(
            r, shapes=[[list(d) for d in s] for s in r["shapes"]])
    del made
    torch.cuda.empty_cache()

    fleet_wall(model, params, draft, dparams, prompts, samp, arrivals, max_new)
    fleet_ab(model, params)
    fleet_fp32(results)


def fleet_wall(model, params, draft, dparams, prompts, samp, arrivals, max_new: int,
               profiled: tuple = (4, 9)) -> None:
    """(c): (a)'s fleet under ``telemetry="wall"``.  The readings each unit
    fed the monitor (host clock, over the unprofiled ticks) beside the
    device time of the same units' steps (torch.profiler over ticks
    ``profiled``, the kernels launched inside each unit's span); gate:
    every request completes, and every measured window closed on an idle
    stream (after the host sync that brings the sampled tokens back, or a
    stage's synchronise), so the monitor read the card's work."""
    from repro_torch.serving.fleet import _Worker
    from torch.profiler import ProfilerActivity, profile
    tag = "[serve-fleet] (c)"
    fleet = full_fleet(model, params, draft, dparams, telemetry="wall")
    rec = instrument_units(fleet)
    paced = {p.name: p for p in fleet._all_paced()}
    readings = {name: [] for name in paced}
    last = {name: p.steps_run for name, p in paced.items()}
    state = {}

    def on_tick(i):
        if i == profiled[0]:
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
        if i == profiled[1]:
            torch.cuda.synchronize()
            state["prof"].__exit__(None, None, None)
        # the readings of the tick before this one (ticks outside the
        # profiled window only)
        if i and not profiled[0] < i <= profiled[1]:
            for name, p in paced.items():
                if p.steps_run != last[name] and p.last_wall_step_s is not None:
                    readings[name].append(p.last_wall_step_s)
        for name, p in paced.items():
            last[name] = p.steps_run
    run = drive_fleet(fleet, prompts, samp, arrivals, max_new, on_tick=on_tick)
    if "prof" not in state or run["snap"].completed != len(prompts):
        raise AssertionError(f"{tag} completed {run['snap'].completed}/{len(prompts)} in "
                             f"{run['ticks']} ticks")
    spans = {e.key: (e.device_time_total, e.count) for e in state["prof"].key_averages()
             if e.key.startswith("unit:") and e.device_type == torch.autograd.DeviceType.CPU}
    not_idle = {n: w.count(False) for n, w in rec["windows"].items() if not all(w)}
    if not_idle:
        raise AssertionError(f"{tag} measured windows closed on a busy stream: {not_idle} (of "
                             f"{ {n: len(w) for n, w in rec['windows'].items()} })")
    parts = []
    for unit in ("host", "phone", "group", "spec"):
        dev_us, n = spans.get(f"unit:{unit}", (0.0, 0))
        members = ([unit] if isinstance(fleet.worker(unit), _Worker)
                   else [m.name for m in fleet.worker(unit).members])
        got = {m: (f"{np.mean(readings[m]) * 1e3:.2f} ms over {len(readings[m])} ticks"
                   if readings[m] else "none") for m in members}
        parts.append(f"{unit}: monitor readings {got}; device time "
                     f"{dev_us / max(n, 1) / 1e3:.2f} ms a step over {n} profiled steps")
    log(f"{tag} telemetry='wall': completed {run['snap'].completed} in {run['ticks']} ticks, "
        f"{run['wall']:.3f} s host wall; every one of "
        f"{sum(len(w) for w in rec['windows'].values())} measured windows closed on an idle "
        f"stream; " + "; ".join(parts) + f"; thermal states "
        f"{ {n: s.thermal_state for n, s in run['snap'].per_worker.items()} }, drains "
        f"{run['snap'].drains}, migrations {run['snap'].migrations}")


def fleet_ab(model, params, n: int = 12, max_new: int = 16, span: float = 1.4) -> None:
    """(d): bench_fleet.py's A/B on the full-width model: its two workers
    (host m2-max-cpu, phone iphone-11-pro, max_batch 3, max_len 96), its
    smoke traffic (12 prompts of 6-15 tokens, every third stochastic,
    arrivals over 1.4 sim s, max_new 16) and its phone throttle, once with
    thermal routing and ServingElasticPolicy and once without; gate: the
    policies recover >= 1.3x goodput (completed tokens per sim s) and
    migrate at least one request."""
    from repro_torch.hw.specs import get_profile
    from repro_torch.runtime.elastic import ServingElasticPolicy
    from repro_torch.serving.fleet import ServingFleet, ThrottleTrace, WorkerSpec, drive_sim
    from repro_torch.serving.sampling import SamplingParams
    tag = "[serve-fleet] (d)"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=int(rng.integers(6, 16)))
               for _ in range(n)]
    samp = [SamplingParams(temperature=2.0, top_k=32, seed=1000 + i) if i % 3 == 0 else None
            for i in range(n)]
    out = {}
    for on in (True, False):
        workers = [WorkerSpec("host", get_profile("m2-max-cpu"), max_batch=3),
                   WorkerSpec("phone", get_profile("iphone-11-pro"), max_batch=3)]
        fleet = ServingFleet(model, params, workers, max_len=96, tick_s=0.05,
                             policy=ServingElasticPolicy() if on else None,
                             throttle=ThrottleTrace({"phone": AB_RAMP}), thermal_routing=on)
        t0 = time.perf_counter()
        with torch.no_grad():
            drive_sim(fleet, np.linspace(0.0, span, n),
                      lambda i: fleet.submit(prompts[i], max_new=max_new, sampling=samp[i]))
        out[on] = (fleet.snapshot(), time.perf_counter() - t0)
    (on, wall_on), (off, wall_off) = out[True], out[False]
    ratio = on.goodput_tokens_per_s / off.goodput_tokens_per_s
    if on.completed != n or off.completed != n or on.migrated_requests < 1 or ratio < 1.3:
        raise AssertionError(f"{tag} completed {on.completed}/{off.completed} of {n}, migrated "
                             f"{on.migrated_requests}, goodput ratio {ratio:.3f}")
    log(f"{tag} bench_fleet's A/B at full width: policies on {on.goodput_tokens_per_s:.3f} "
        f"tokens per sim s ({on.sim_t:.2f} sim s, {on.migrations} migrations, "
        f"{on.migrated_requests} requests moved, {on.drains} drains; phone "
        f"{on.per_worker['phone'].goodput_tokens_per_s:.3f}), off "
        f"{off.goodput_tokens_per_s:.3f} ({off.sim_t:.2f} sim s; phone "
        f"{off.per_worker['phone'].goodput_tokens_per_s:.3f}): {ratio:.3f}x (gate >= 1.3); host "
        f"wall {wall_on:.2f} and {wall_off:.2f} s")


def fleet_fp32(results: dict) -> None:
    """(b): the reference's fp32 identity claims on the card.  granite-8b's
    full width cut to 4 layers and rwkv6-1.6b's cut to 4, fp32 (TF32 off):
    test_failover.py's kill fleets (two workers, rate 20, max_batch 4,
    max_len 48, 6 requests half stochastic, max_new 8, a seeded crash of
    ``b``) over dense, paged (48 blocks of 4) and recurrent lanes at seeds
    3 and 4, test_fleet.py's migration run, and test_pipeline_decode.py's
    rebalance of a 2-member StageGroup; every token equal to an unmigrated
    single engine's on the card, no block left in use.  Each model's fleet
    runs are counted as one: their launches equal the units' prefill
    dispatches and decode steps (``units_want``), and each kernel call is
    held against its plain version.  The witnesses run after the count."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.hw.specs import DeviceProfile
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.runtime.elastic import ServingElasticPolicy
    from repro_torch.runtime.faults import make_kill_trace
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.fleet import (ServingFleet, StageGroup, ThrottleTrace,
                                           WorkerSpec, drive_sim)
    from repro_torch.serving.sampling import SamplingParams
    tag = "[serve-fleet] (b)"
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)

    def prof(name, rate=20.0, link=1e9, prefill=1e9):
        return DeviceProfile(name=name, year=2024, flops=1e12, mem_bytes=1e12, mem_bw=60e9,
                             link_bw=link, decode_steps_per_s=rate,
                             prefill_tokens_per_s=prefill)

    def traffic(vocab, n, seed, temp, top_k, seed0, size0=6):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, vocab, size=size0 + i) for i in range(n)]
        samp = [SamplingParams(temperature=temp, top_k=top_k, seed=seed0 + i) if i % 2 else None
                for i in range(n)]
        return prompts, samp

    def unmigrated(model, params, prompts, samp, max_new, config=None):
        ref = ServeEngine(model, params, max_batch=len(prompts), max_len=48, config=config)
        for p, s in zip(prompts, samp):
            ref.submit(p, max_new=max_new, sampling=s)
        return {r.rid: r.out_tokens for r in ref.run_until_drained()}

    def check(what, fleet, want, model, params, prompts):
        got = {r.req.rid: r.req.out_tokens for r in fleet.completed}
        if got != want:
            diffs = [(rid, *first_diff_margin(model, params, prompts[rid], got[rid], want[rid],
                                              48))
                     for rid in want if got.get(rid) != want[rid]]
            raise AssertionError(f"{tag} {what}: tokens differ from the unmigrated engine's "
                                 f"(rid, position, want, got, margin): {diffs}")
        leaked = {w.name: w.engine.backend.blocks_in_use for w in fleet.workers
                  if w.engine.backend.name == "paged" and w.engine.backend.blocks_in_use}
        if leaked:
            raise AssertionError(f"{tag} {what}: blocks in use after the drain {leaked}")
        return sum(len(t) for t in got.values())

    def kill_run(model, params, config, seed):
        prompts, samp = traffic(model.cfg.vocab_size, 6, seed, 2.0, 32, 300)
        fleet = ServingFleet(
            model, params, [WorkerSpec(nm, prof(f"dev-{nm}"), max_batch=4,
                                       engine_config=config) for nm in "ab"],
            max_len=48, tick_s=0.05,
            kill_trace=make_kill_trace(["b"], 1, t0_s=0.4, t1_s=0.6, seed=seed))
        drive_sim(fleet, np.linspace(0.0, 0.3, 6), lambda i: fleet.submit(
            prompts[i], max_new=8, sampling=samp[i]))
        return fleet, prompts, samp, config

    def migration_run(model, params):
        # test_fleet.py's migration run
        prompts = [np.random.default_rng(10 + i).integers(0, model.cfg.vocab_size, size=6 + i)
                   for i in range(6)]
        samp = [SamplingParams(temperature=3.0, top_k=16, seed=50 + i) if i % 2 else None
                for i in range(6)]
        fleet = ServingFleet(model, params, [WorkerSpec(nm, prof(f"dev-{nm}"), max_batch=2)
                                             for nm in "ab"],
                             max_len=48, tick_s=0.05, policy=ServingElasticPolicy(),
                             throttle=ThrottleTrace({"b": (0.2, 6.0, 0.1)}))
        drive_sim(fleet, np.linspace(0.0, 0.5, 6), lambda i: fleet.submit(
            prompts[i], max_new=8, sampling=samp[i]))
        return fleet, prompts, samp, None

    def rebalance_run(model, params):
        # test_pipeline_decode.py's rebalance
        prompts, samp = traffic(model.cfg.vocab_size, 6, 9, 2.0, 16, 700)
        grp = StageGroup("pair", (WorkerSpec("s0", prof("d0", link=1e6, prefill=1e5)),
                                  WorkerSpec("s1", prof("d1", link=1e6, prefill=1e5))),
                         cuts=(2,), max_batch=3)
        fleet = ServingFleet(model, params, groups=[grp], max_len=48, tick_s=0.05,
                             policy=ServingElasticPolicy(),
                             throttle=ThrottleTrace({"s1": (0.3, 6.0, 0.1)}))
        drive_sim(fleet, np.linspace(0.0, 0.5, 6), lambda i: fleet.submit(
            prompts[i], max_new=8, sampling=samp[i]))
        return fleet, prompts, samp, None

    lines = []
    for arch in ("granite-8b", "rwkv6-1.6b"):
        model = build_model(dataclasses.replace(get_config(arch), n_layers=4), rcfg,
                            device="cuda")
        params = model.init(0)
        if arch == "granite-8b":
            launches = unsplit_launches(model, params, np.arange(6), 4, 48)
            paged = EngineConfig(kv_blocks=48, kv_block_size=4)
            plan = [(f"dense kill seed {s}", lambda s=s: kill_run(model, params, None, s))
                    for s in (3, 4)]
            plan += [(f"paged kill seed {s}", lambda s=s: kill_run(model, params, paged, s))
                     for s in (3, 4)]
            plan += [("migration", lambda: migration_run(model, params)),
                     ("rebalance", lambda: rebalance_run(model, params))]
        else:
            launches = recurrent_launches(model.cfg)
            plan = [(f"recurrent kill seed {s}", lambda s=s: kill_run(model, params, None, s))
                    for s in (3, 4)]
        runs = {}

        def drive():
            for what, run in plan:
                runs[what] = run()
        with torch.no_grad():
            ops.reset_launch_counts()
            served = check_served_kernels(
                f"{tag} {arch}", drive,
                lambda: units_want([f for f, _, _, _ in runs.values()], launches))
            counts = ops.launch_counts()
            check_launches(counts, units_want([f for f, _, _, _ in runs.values()], launches),
                           f"{tag} {arch}")
            add_launches(results, counts, f"fleet fp32 {arch}")
            lines.append(f"{arch}: launches {nonzero(counts)} over {len(runs)} fleet runs, "
                         f"held against the plain versions (worst margin " + ", ".join(
                             f"{k} {v['margin']:.3f}" for k, v in served.items()) + ")")
            for what, (fleet, prompts, samp, config) in runs.items():
                snap = fleet.snapshot()
                if "kill" in what:
                    if (snap.completed != 6 or snap.deaths != 1 or snap.resurrections < 1
                            or snap.orphaned):
                        raise AssertionError(f"{tag} {arch} {what}: {snap}")
                    note = (f"{snap.resurrections} resurrections, {snap.recompute_tokens} "
                            f"recompute tokens")
                elif what == "migration":
                    if snap.completed != 6 or snap.migrated_requests < 1:
                        raise AssertionError(f"{tag} migration run: {snap}")
                    note = f"{snap.migrated_requests} requests moved"
                else:
                    gs = snap.per_group["pair"]
                    if (snap.completed != 6 or gs.recuts < 1 or gs.cuts[0] <= 2
                            or gs.recut_bytes <= 0):
                        raise AssertionError(f"{tag} rebalance: {gs}")
                    note = f"cuts (2,) -> {gs.cuts}, {gs.recut_bytes} B moved"
                check(f"{arch} {what}", fleet, unmigrated(model, params, prompts, samp, 8,
                                                          config), model, params, prompts)
                lines.append(f"{arch} {what}: {note}")
        del model, params, runs
        torch.cuda.empty_cache()
    log(f"{tag} fp32, 4 layers at full width: every token equal to an unmigrated single "
        f"engine's on the card, no block in use after any drain: " + "; ".join(lines))


# ---------------------------------------------------------------------------
# phase 18: the federated serve-while-train plane over a granite-8b fleet
# ---------------------------------------------------------------------------

FED_LAYERS = 2          # granite-8b's full width cut to 2 layers, fp32: ~0.64 B params
# rounds at full width: one.  zlib level 6 (the FEDR frame's DEFLATE, fixed
# by its format) takes ~67 s on the host for one 637 MB int8 stream, two a
# round; two rounds of it would take the phase past four minutes
FED_ROUNDS = 1
# local-SGD lr: the reference's 0.3 was set for its reduced model; the probe
# the phase prints first shows it works at full width too (PERF.md)
FED_LR = 0.3
FED_PROBE_LRS = (0.01, 0.03, 0.1, 0.3, 1.0)
# bench_fed.py's own configuration, where its loss claim is made: reduced
# granite (2 layers, fp32), 6 rounds, lr 0.3; int8_ef's held-out loss may
# exceed bf16's by LOSS_EPS and must fall by 0.5 from the init.  The bench
# makes the claim at one init, jax.random.key(0), which the port cannot draw;
# at other inits it fails in both packages alike (seed 4 of the port's
# inits: int8_ef above bf16 by 0.0107 in each, tests/test_torch_fed.py's
# test_bench_fed_loss_gap_matches_the_reference), so the phase holds the
# mean over BENCH_SEEDS inits, each drawn on the CPU as the test draws it,
# and holds every seed's card run to the port's CPU run from the same init
BENCH_ROUNDS = 6
BENCH_SEEDS = tuple(range(6))
FED_LOSS_EPS = 5e-3
# held-out loss after the rounds, card vs CPU from one init, each mode and
# the gap between them (the test's tolerance for port vs reference)
BENCH_LOSS_TOL = 2e-4


def fed_heldout(model, params) -> float:
    """bench_fed.py's held-out loss: 8 sequences of 32 tokens from another
    seed's stream (seed 7, step 999)."""
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    batch = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                                     global_batch=8, seed=7)).batch(999)
    with torch.no_grad():
        loss, _ = model.loss(params, {"tokens": torch.as_tensor(batch["tokens"],
                                                                device=model.device)})
    return float(loss)


def fed_coordinator(serve_model, serve_params, model, init, mode: str, rounds: int,
                    profile=None, max_len: int = 128, kill_trace=None):
    """A FedRoundCoordinator over three replica workers (``profile``, by
    default the H100's; max_batch 4) serving ``serve_model``, training
    ``model`` from ``init``: 2 participants, 2 local steps of 4 x 32
    tokens, lr ``FED_LR``, frames in ``mode``."""
    from repro_torch.hw.specs import H100
    from repro_torch.serving.failover import FailoverConfig
    from repro_torch.serving.fleet import ServingFleet, WorkerSpec
    from repro_torch.serving.train_plane import FedConfig, FedRoundCoordinator
    workers = [WorkerSpec(n, profile or H100, max_batch=4) for n in ("a", "b", "c")]
    fleet = ServingFleet(serve_model, serve_params, workers, max_len=max_len, tick_s=0.05,
                         kill_trace=kill_trace,
                         failover=FailoverConfig(checkpoint_every_s=0.5)
                         if kill_trace is not None else None)
    fc = FedConfig(rounds=rounds, local_steps=2, participants=2, batch=4, seq_len=32,
                   lr=FED_LR, seed=0, mode=mode)
    return FedRoundCoordinator(fleet, model, fc, params=init)


def timed_frames(fed) -> dict:
    """Time the frame codec's parts while the coordinator runs: swap the
    ``fed`` module's ``compress``, ``codec`` and ``zlib`` for timed twins
    (``compress_tree`` synchronised, so its time is the card's) and return
    {part: [seconds, ...]}; ``restore()`` puts the modules back."""
    from types import SimpleNamespace
    from repro_torch.optim import compress
    from repro_torch.wire import codec
    seen = {"restore": (fed.compress, fed.codec, fed.zlib)}

    def timed(key, fn, sync=False):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            seen.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return call
    fed.compress = SimpleNamespace(init_error=compress.init_error,
                                   compress_tree=timed("quantise", compress.compress_tree, True),
                                   decompress_tree=timed("dequantise", compress.decompress_tree,
                                                         True))
    fed.codec = SimpleNamespace(dumps=timed("codec dumps", codec.dumps),
                                loads=timed("codec loads", codec.loads))
    fed.zlib = SimpleNamespace(compress=timed("zlib compress", zlib.compress),
                               decompress=timed("zlib decompress", zlib.decompress))
    return seen


def untime_frames(fed, seen: dict) -> dict:
    fed.compress, fed.codec, fed.zlib = seen.pop("restore")
    return {k: f"{1e3 * sum(v) / len(v):.1f} ms x {len(v)}" for k, v in seen.items()}


def phase_fed(results: dict, serve_model, serve_params) -> None:
    """The federated plane on one card: FedRoundCoordinators over three
    bf16 granite-8b replica workers (phase 6's weights) train granite-8b's
    full width cut to 2 layers, fp32 (0.64 B params), 2 participants x 2
    local steps a round, FED_ROUNDS rounds.  First an lr probe (4 local
    steps per lr, held-out loss).  Gates, test_fed.py's and bench_fed.py's
    claims: int8_ef frames >= 3x smaller than bf16's, and the held-out loss
    falling in both modes; two seeded bf16 replays bit-identical; serving
    tokens identical with training on and off; a crash mid-round losing no
    round and excluding the dead participant; flash and RMSNorm of a local
    step against their plain versions.  The int8_ef run times the frame
    codec's parts.  Then bench_fed.py's own configuration (reduced granite,
    6 rounds), where its loss claim is made, from each of BENCH_SEEDS'
    inits, drawn on the CPU and run on the card and on the CPU: int8_ef's
    mean held-out loss on the card equal or better than bf16's, every
    seed's losses and gap within BENCH_LOSS_TOL of the CPU's, seed 0's
    replay bit-identical, the wire cut at every seed."""
    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.convert import leaves, move_params, stack_blocks
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.hw.specs import H100, DeviceProfile
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.optim import fed
    from repro_torch.runtime.faults import KillEvent, KillTrace
    from repro_torch.serving.fleet import drive_sim
    from repro_torch.serving.train_plane import _local_sgd_step
    tag = "[fed]"
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=FED_LAYERS)
    model = build_model(cfg, rcfg, device="cuda")
    init = model.init(0)
    n_params = sum(t.numel() for t in leaves(init))
    loss_init = fed_heldout(model, init)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=12,
                                    seed=0), shard=0, n_shards=3)
    probe = {}
    for lr in FED_PROBE_LRS:
        step, p = _local_sgd_step(model, lr), init
        for s in range(4):
            p, _, _ = step(p, {}, pipe.batch(s))
        probe[lr] = fed_heldout(model, p)
        del p
    log(f"{tag} granite-8b full width, {FED_LAYERS} layers, fp32: {n_params} params "
        f"({n_params * 4 / 1e9:.2f} GB); held-out loss at init {loss_init:.4f}; after 4 "
        f"local-SGD steps of 4 x 32 tokens by lr: "
        + ", ".join(f"{lr}: {v:.4f}" for lr, v in probe.items()) + f"; the phase runs lr {FED_LR}")

    failed = []         # gates whose failure must not hide the other readings
    runs = {}
    for name, mode in (("int8_ef", "int8_ef"), ("bf16", "bf16"), ("bf16 replay", "bf16")):
        coord = fed_coordinator(serve_model, serve_params, model, init, mode, FED_ROUNDS)
        parts = timed_frames(fed) if name != "bf16 replay" else None
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            coord.run_rounds()
            torch.cuda.synchronize()
        finally:
            parts = untime_frames(fed, parts) if parts is not None else {}
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if coord.rounds_done != FED_ROUNDS or coord.deliveries != 2 * FED_ROUNDS:
            raise AssertionError(f"{tag} {name}: {coord.rounds}")
        runs[name] = dict(params=coord.params, wire=coord.wire_bytes_total, rounds=coord.rounds,
                          loss=fed_heldout(model, coord.params))
        log(f"{tag} {name}: {coord.rounds_done} round(s) in {wall:.2f} s host wall, wire "
            f"{coord.wire_bytes_total} B, train {coord.train_s_total:.4f} sim s; "
            + "; ".join(f"round {r.round_id}: {r.delivered} loss {r.loss_first:.4f} -> "
                        f"{r.loss_last:.4f}, {r.wire_bytes} B, t {r.t_begin:.2f}-{r.t_end:.2f}"
                        for r in coord.rounds)
            + f"; held-out loss {runs[name]['loss']:.4f}; launches {nonzero(counts)}"
            + (f"; frame codec by part {parts}" if parts else ""))
        if name == "int8_ef":
            add_launches(results, counts, "fed")
        del coord
        torch.cuda.empty_cache()
    a, bf, rep = runs["int8_ef"], runs["bf16"], runs["bf16 replay"]
    ratio = bf["wire"] / a["wire"]
    same = (all(torch.equal(x, y) for x, y in zip(leaves(bf["params"]), leaves(rep["params"])))
            and bf["rounds"] == rep["rounds"])
    if not same:
        pairs = (leaves(bf["params"]), leaves(rep["params"]))
        failed.append(f"two seeded bf16 replays differ in "
                      f"{sum(int((x != y).sum()) for x, y in zip(*pairs))} "
                      f"param entries")
    if ratio < 3.0 or not a["loss"] < loss_init or not bf["loss"] < loss_init:
        failed.append(f"int8_ef frames {ratio:.3f}x smaller than bf16's (gate >= 3), held-out "
                      f"loss int8_ef {a['loss']:.4f}, bf16 {bf['loss']:.4f}, init {loss_init:.4f}")
    log(f"{tag} two seeded bf16 replays: params bit-identical {same}; int8_ef frames "
        f"{ratio:.3f}x smaller than bf16's (gate >= 3); held-out loss {loss_init:.4f} -> "
        f"int8_ef {a['loss']:.4f}, bf16 {bf['loss']:.4f} after {FED_ROUNDS} round(s) (int8_ef's "
        f"top-k leaves half the delta's mass in its error feedback for later rounds)")
    del runs, a, bf, rep

    # serving traffic with training on (bf16 frames) and off
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, serve_model.cfg.vocab_size, size=int(n))
               for n in rng.integers(8, 64, size=6)]
    arrivals = np.linspace(0.0, 0.4, len(prompts))

    def serve(target):
        with torch.no_grad():
            drive_sim(target, arrivals, lambda i: target.submit(prompts[i], max_new=8))
        return {r.req.rid: list(r.req.out_tokens) for r in target.completed}
    on = fed_coordinator(serve_model, serve_params, model, init, "bf16", FED_ROUNDS)
    tokens_on = serve(on)
    on.run_rounds()
    off = fed_coordinator(serve_model, serve_params, model, init, "bf16", FED_ROUNDS).fleet
    if serve(off) != tokens_on or on.rounds_done != FED_ROUNDS:
        failed.append(f"serving tokens with training on equal those with it off: "
                      f"{serve(off) == tokens_on}; {on.rounds_done} rounds")
    log(f"{tag} serving {len(prompts)} requests with training on (rounds "
        + "; ".join(f"{r.round_id}: participants {r.participants}, t {r.t_begin:.2f}-"
                    f"{r.t_end:.2f}" for r in on.rounds)
        + f", {on.preempt_ticks} ticks preempted by serving) and off: tokens identical")
    del on, off
    torch.cuda.empty_cache()

    # a crash of participant b halfway through its bf16 frame's flight over
    # the H100 profile's link, in round 0
    t_crash = 0.15 + n_params * 2 / H100.link_bw / 2
    trace = KillTrace(events=(KillEvent(t_s=t_crash, worker="b", kind="crash",
                                        down_s=float("inf")),))
    coord = fed_coordinator(serve_model, serve_params, model, init, "bf16", FED_ROUNDS,
                            kill_trace=trace)
    coord.run_rounds()
    hit = [r for r in coord.rounds if "b" in r.excluded]
    if (coord.rounds_done != FED_ROUNDS or not hit or any("b" in r.delivered for r in hit)
            or any(r.samples != len(r.delivered) * 8 for r in coord.rounds)):
        failed.append(f"crash run: {coord.rounds}")
    log(f"{tag} b crashes at {t_crash:.3f} sim s, mid-round: {coord.rounds_done} round(s), none "
        f"lost; " + "; ".join(f"round {r.round_id}: delivered {r.delivered}, excluded "
                               f"{r.excluded}, {r.samples} samples" for r in coord.rounds)
        + f"; failure log {coord.fleet.failure_log}")
    del coord
    torch.cuda.empty_cache()

    # flash and RMSNorm of a local step against their plain versions, the
    # step's device time, and one delta's device-to-host copy
    step = _local_sgd_step(model, FED_LR)
    batch = pipe.batch(0)
    ops.reset_launch_counts()
    new, _, _ = step(init, {}, batch)
    one = ops.launch_counts()
    if not one["flash_attention"] or not one["rmsnorm"]:
        raise AssertionError(f"{tag} a local step launched {one}")
    served = check_served_kernels(f"{tag} local step", lambda: step(init, {}, batch), one)
    log(f"{tag} a local step's forward kernels (B=4 T=32) against their plain versions, worst "
        f"margin (error / limit): " + "; ".join(f"{k} {v['calls']} calls, {v['margin']:.3f}"
                                               for k, v in served.items()))
    profile_step(lambda: step(init, {}, batch), "local SGD step (granite-8b width, 2 layers, "
                                               "fp32, 4 x 32 tokens)", top=6, reps=2)
    delta = stack_blocks(fed.tree_delta(new, init))
    del new
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [t.cpu() for t in leaves(delta)]
    d2h = time.perf_counter() - t0
    log(f"{tag} one delta ({n_params} fp32 entries, {sum(t.nbytes for t in host)} B): "
        f"device-to-host copy {d2h * 1e3:.1f} ms (pageable memory)")
    del host, delta
    torch.cuda.empty_cache()

    # bench_fed.py's configuration: its loss claim over BENCH_SEEDS inits,
    # each run on the card and on the CPU, its replay (seed 0), its wire cut
    bcfg = dataclasses.replace(reduced_config(get_config("granite-8b")), n_layers=2)
    bmodels = {"card": build_model(bcfg, rcfg, device="cuda"),
               "cpu": build_model(bcfg, rcfg, device="cpu")}
    bprof = DeviceProfile(name="bench", year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                          link_bw=1e9, decode_steps_per_s=20.0, prefill_tokens_per_s=2000.0)
    bench, cpu_s = [], 0.0
    for seed in BENCH_SEEDS:
        cinit = bmodels["cpu"].init(seed)
        inits = {"card": move_params(cinit, "cuda"), "cpu": cinit}
        row = dict(seed=seed, init=fed_heldout(bmodels["card"], inits["card"]))
        for where, bmodel in bmodels.items():
            t0 = time.perf_counter()
            modes = ("int8_ef", "bf16") + (("int8_ef replay",) if seed == 0 and where == "card"
                                           else ())
            for mode in modes:
                c = fed_coordinator(bmodel, inits[where], bmodel, inits[where], mode.split()[0],
                                    BENCH_ROUNDS, profile=bprof, max_len=64)
                c.run_rounds()
                row[where, mode] = dict(params=c.params, wire=c.wire_bytes_total,
                                        rounds=c.rounds_done, loss=fed_heldout(bmodel, c.params))
            row[where, "gap"] = row[where, "int8_ef"]["loss"] - row[where, "bf16"]["loss"]
            if where == "cpu":
                cpu_s += time.perf_counter() - t0
        bench.append(row)
    first = bench[0]
    b_same = all(torch.equal(x, y) for x, y in zip(leaves(first["card", "int8_ef"]["params"]),
                                                  leaves(first["card", "int8_ef replay"]
                                                         ["params"])))
    ratios = [r["card", "bf16"]["wire"] / r["card", "int8_ef"]["wire"] for r in bench]
    mean_i8 = float(np.mean([r["card", "int8_ef"]["loss"] for r in bench]))
    mean_bf = float(np.mean([r["card", "bf16"]["loss"] for r in bench]))
    rounds = {r[w, m]["rounds"] for r in bench for w in bmodels for m in ("int8_ef", "bf16")}
    witness = max(abs(r["card", k] - r["cpu", k]) if k == "gap"
                  else abs(r["card", k]["loss"] - r["cpu", k]["loss"])
                  for r in bench for k in ("int8_ef", "bf16", "gap"))
    if (rounds != {BENCH_ROUNDS} or not b_same or min(ratios) < 3.0
            or not mean_i8 <= mean_bf + FED_LOSS_EPS or not witness <= BENCH_LOSS_TOL
            or any(not r["card", "int8_ef"]["loss"] < r["init"] - 0.5 for r in bench)):
        failed.append(f"bench_fed's configuration: rounds {rounds}, replay identical {b_same}, "
                      f"wire cut {min(ratios):.3f}x at least, mean held-out loss int8_ef "
                      f"{mean_i8:.4f}, bf16 {mean_bf:.4f}, card vs CPU at most {witness:.2e} "
                      f"apart")
    log(f"{tag} bench_fed.py's configuration (reduced granite, 2 layers, fp32, {BENCH_ROUNDS} "
        f"rounds, lr {FED_LR}), inits {list(BENCH_SEEDS)} drawn on the CPU: held-out loss on the "
        f"card (init -> int8_ef, bf16; int8_ef less bf16 on the card, on the CPU) "
        + "; ".join(f"seed {r['seed']}: {r['init']:.4f} -> {r['card', 'int8_ef']['loss']:.6f}, "
                    f"{r['card', 'bf16']['loss']:.6f} ({r['card', 'gap']:+.6f}, "
                    f"{r['cpu', 'gap']:+.6f})" for r in bench)
        + f"; mean int8_ef {mean_i8:.6f} against bf16 {mean_bf:.6f} (gate: int8_ef <= bf16 + "
        f"{FED_LOSS_EPS}, and each below its init - 0.5); card vs CPU: losses and gaps at most "
        f"{witness:.2e} apart (gate {BENCH_LOSS_TOL}); the CPU runs took {cpu_s:.1f} s; frames "
        f"{min(ratios):.3f}-{max(ratios):.3f}x smaller than bf16's; seed 0's int8_ef replay "
        f"bit-identical {b_same}")
    if failed:
        raise AssertionError(f"{tag} " + "; ".join(failed))


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


def profile_step(fn, what: str, top: int = 8, reps: int = 3, spans: tuple = (),
                 share: str = ""):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler)
    against the unprofiled wall time of a call; returns the kernel rows
    (device us over the calls, launches, name).  With ``share``, the kernels
    whose name holds that string are summed and their share of the device
    time logged.  With ``spans``, host activity is traced too and the device
    time of the kernels launched inside each named ``record_function`` span
    is returned beside the rows ({name: (device us over the calls,
    entries)})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / reps
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if spans else [])
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    table = prof.key_averages()
    # kernel rows only: an aten op's row repeats the time of the kernels it ran
    # (a span's own device-side annotation row is not a kernel)
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in table
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key not in spans), reverse=True)
    busy = sum(r[0] for r in rows) / reps
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms per call, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {sum(r[1] for r in rows) // reps} "
        f"kernel launches")
    for t_us, n, key in rows[:top]:
        log(f"[profile]   {t_us / reps / 1e3:8.3f} ms  {n // reps:5d} launches  {key[:90]}")
    if share:
        mine = [r for r in rows if share in r[2]]
        if not mine:
            raise AssertionError(f"profile of {what}: no kernel named *{share}*")
        t_us = sum(r[0] for r in mine) / reps
        log(f"[profile]   kernels *{share}*: {t_us / 1e3:.4f} ms a call, "
            f"{sum(r[1] for r in mine) // reps} launches, {100 * t_us / busy:.1f}% of the "
            f"device time")
    if not spans:
        return rows
    found = {e.key: (e.device_time_total, e.count) for e in table
             if e.key in spans and e.device_type == torch.autograd.DeviceType.CPU}
    missing = [name for name in spans if not found.get(name, (0,))[0] > 0]
    if missing:
        seen = [(e.key, e.device_type, e.device_time_total, e.count) for e in table
                if e.key in spans]
        raise AssertionError(f"profile of {what}: no kernel time inside span {missing}: {seen}")
    return rows, found


# ---------------------------------------------------------------------------
# phases 11-13: training, card vs CPU, full-width rwkv6-1.6b and zamba2-7b
# ---------------------------------------------------------------------------

def _loss_and_grads(model, params, tokens):
    from repro_torch.convert import leaves
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": tokens})
    return loss.detach(), torch.autograd.grad(loss, flat)


def phase_parity_train(n_layers: int = 4, full_width_layers: int = 2) -> None:
    """Reduced rwkv6, granite and zamba2 (``n_layers``; zamba2's shared block
    fires at layers 0 and 2), rwkv6-1.6b at full width (d_model 2048, 32
    heads of 64, d_ff 7168, vocab 65536) and zamba2-7b at full width
    (d_model 3584, 112 SSM heads of 64, state 64, the shared block's 32
    heads of 112, d_ff 14336, vocab 32000) cut to ``full_width_layers``
    (zamba2's shared block fires once), in fp32 with the same weights on
    the card and the CPU: the loss, every gradient leaf (through the
    kernels' autograd wrappers on the card, at the training path's shapes
    in the full-width cases) and the losses of 3 AdamW steps of the
    launcher's step function on TokenPipeline batches of 4 x 128 tokens
    (2 x 128 for full-width zamba2, whose CPU side is the slowest)."""
    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.convert import move_params
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    cases = [(f"{arch} reduced", dataclasses.replace(reduced_config(get_config(arch)),
                                                     n_layers=n_layers), path, 4)
             for arch, path in (("rwkv6-1.6b", RWKV_TRAIN_PATH), ("granite-8b", DENSE_TRAIN_PATH),
                                ("zamba2-7b", HYBRID_TRAIN_PATH))]
    cases.append(("rwkv6-1.6b full width", dataclasses.replace(
        get_config("rwkv6-1.6b"), n_layers=full_width_layers), RWKV_TRAIN_PATH, 4))
    cases.append(("zamba2-7b full width", dataclasses.replace(
        get_config("zamba2-7b"), n_layers=full_width_layers), HYBRID_TRAIN_PATH, 2))
    for arch, cfg, path, batch in cases:
        rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
        cpu, gpu = build_model(cfg, rcfg, device="cpu"), build_model(cfg, rcfg, device="cuda")
        p_cpu = cpu.init(0)
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                 size=(batch, 128)))
        ops.reset_launch_counts()
        l_g, g_g = _loss_and_grads(gpu, move_params(p_cpu, "cuda"), toks.cuda())
        counts = ops.launch_counts()
        l_c, g_c = _loss_and_grads(cpu, p_cpu, toks)
        check_train_path(counts, path, f"{arch} training parity")
        loss_err = abs(l_g.item() - l_c.item()) / abs(l_c.item())
        if not loss_err <= TRAIN_LOSS_TOL:
            raise AssertionError(f"{arch} loss card {l_g.item()} vs CPU {l_c.item()}")
        grad_err = 0.0
        for i, (a, ref) in enumerate(zip(g_g, g_c)):
            e = (a.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            if not e <= GRAD_TOL:
                raise AssertionError(f"{arch} gradient leaf {i}: {e:.3e} beyond {GRAD_TOL}")
            grad_err = max(grad_err, e)
        # 3 AdamW steps of the launcher's step function on both devices
        opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3, weight_decay=0.01)
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                        global_batch=batch))
        losses = {}
        for dev, model in (("cuda", gpu), ("cpu", cpu)):
            params = move_params(p_cpu, dev)
            opt, step = adamw.init(params), make_step_fn(model, opt_cfg)
            data = token_batches(pipe, 0, dev)
            losses[dev] = []
            for _ in range(3):
                params, opt, m = step(params, opt, next(data))
                losses[dev].append(m["loss"].item())
        step_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        if not step_err <= STEP_LOSS_TOL:
            raise AssertionError(f"{arch} AdamW losses card {losses['cuda']} vs CPU "
                                 f"{losses['cpu']}")
        log(f"[parity-train] {arch} (d_model {cfg.d_model}, {cfg.n_layers} layers), fp32, "
            f"{batch} x 128 tokens: loss card "
            f"{l_g.item():.6f} vs CPU {l_c.item():.6f} (rel {loss_err:.2e}, tol "
            f"{TRAIN_LOSS_TOL}); {len(g_c)} gradient leaves, worst {grad_err:.2e} of max(1, "
            f"max|g|) (tol {GRAD_TOL}); 3 AdamW steps: losses card {losses['cuda']} vs CPU "
            f"{losses['cpu']} (worst rel {step_err:.2e}, tol {STEP_LOSS_TOL}); launches {counts}")


def run_trainer(model, opt_cfg, pipe, params, n_steps: int, ckpt_dir: Path, ckpt_every: int):
    """``n_steps`` of the launcher's step function through the Trainer from
    ``params``, launch counts set to 0 just before: (trainer output, launch
    counts, peak device bytes, wall s, a CUDA event recorded after each step)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    events = []

    def on_metrics(step, rec):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    tr = Trainer(TrainerConfig(total_steps=n_steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                               log_every=5),
                 make_step_fn(model, opt_cfg), lambda: (params, adamw.init(params)),
                 lambda start: token_batches(pipe, start, model.device), on_metrics=on_metrics)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, ops.launch_counts(), torch.cuda.max_memory_allocated(), wall, events


def log_steps(tag: str, out: dict, events: list, warmup: int, batch: int, seq: int,
              n_steps: int,
              loss_before: float, loss_after: float, useful_params: int, what: str, peak: int,
              wall: float) -> None:
    """Step time (trainer's clock and card events, after ``warmup`` steps),
    tok/s, MFU = 6 x ``useful_params`` x tokens / step time / 989 TFLOP/s,
    losses and peak memory of a training run."""
    losses = out["losses"]
    host_ms = [r["step_s"] * 1e3 for r in out["history"][warmup:]]
    dev_ms = [a.elapsed_time(b) for a, b in zip(events[warmup:], events[warmup + 1:])]
    step_ms = float(np.median(host_ms))
    tokens = batch * seq
    flops = 6.0 * useful_params * tokens
    log(f"[{tag}] {n_steps} steps of {batch} x {seq} tokens, lr {TRAIN_LR}: training loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, held-out batch {loss_before:.4f} -> "
        f"{loss_after:.4f}; step after {warmup} warm-up steps: median {step_ms:.1f} ms by the "
        f"trainer's clock (min {min(host_ms):.1f}, max {max(host_ms):.1f}), median "
        f"{float(np.median(dev_ms)):.1f} ms between card events; {tokens / step_ms * 1e3:.0f} "
        f"tok/s; MFU {flops / (step_ms / 1e3) / PEAK_BF16_FLOPS:.4f} (6 x {useful_params} "
        f"{what} x {tokens} tokens per step / step time / 989 TFLOP/s bf16 dense; remat's "
        f"recompute not counted as useful work); peak device memory {peak / 2**30:.2f} GiB; "
        f"run wall {wall:.1f} s of which steps {sum(r['step_s'] for r in out['history']):.1f} s")
    log(f"[{tag}] per-step training losses: {', '.join(f'{x:.4f}' for x in losses)}")


def phase_train(results: dict, n_steps: int = 20, warmup: int = 3) -> None:
    """rwkv6-1.6b at full width and depth, bf16 params and compute with
    per-block remat (the RunConfig defaults), random weights from seed 0,
    trained through the launcher's step function and Trainer on 8 x 512
    TokenPipeline tokens.  AdamW as the reference launcher sets it
    (warmup 10, weight decay 0.01) but at lr ``TRAIN_LR``: the launcher's
    3e-3, set for its reduced config, raised this model's loss.  The loss
    must fall on a held-out batch, evaluated before and after."""
    import shutil
    from repro_torch.checkpoint.store import restore
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    cfg, rcfg = get_config("rwkv6-1.6b"), RunConfig()
    batch, seq = 8, 512
    model = build_model(cfg, rcfg, device="cuda")
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=n_steps,
                                weight_decay=0.01)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=rcfg.seed))
    held_out = next(token_batches(pipe, 100_000, model.device))     # a step the run never takes

    def eval_loss(p):
        with torch.no_grad():
            return model.loss(p, held_out)[0].item()
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    n_embed = params["embed"]["tok"].numel() + params["head"]["w"].numel()
    log(f"[train] rwkv6-1.6b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
        f"{cfg.vocab_size}: {n_params} params ({n_params - n_embed} outside the embedding and "
        f"head), bf16, drawn on the card in {time.perf_counter() - t0:.1f} s")
    loss_before = eval_loss(params)
    out, counts, peak, wall, events = run_trainer(model, opt_cfg, pipe, params, n_steps,
                                                  ckpt_dir, ckpt_every=n_steps)
    losses = out["losses"]
    check_train_path(counts, RWKV_TRAIN_PATH, "full-width rwkv6 training")
    per_fwd = cfg.n_layers * (2 if rcfg.remat else 1)
    if counts["rwkv6_scan"] != per_fwd * n_steps or \
            counts["rwkv6_scan_bwd"] != cfg.n_layers * n_steps or counts["flash_attention"]:
        raise AssertionError(f"launches {counts}: the rwkv6 kernel must run {per_fwd} times a "
                             f"step ({cfg.n_layers} layers, remat {rcfg.remat}) and its "
                             f"backward kernel {cfg.n_layers}")
    loss_after = eval_loss(out["params"])
    if not all(np.isfinite(losses)) or not loss_after < loss_before:
        raise AssertionError(f"training losses {losses}, held-out loss {loss_before} -> "
                             f"{loss_after}: not finite or not falling")
    log_steps("train", out, events, warmup, batch, seq, n_steps, loss_before, loss_after,
              n_params - n_embed, "non-embedding params", peak, wall)
    log(f"[train] launches over the run: {counts}")
    # the checkpoint the trainer wrote at the last step restores bit-equal
    t0 = time.perf_counter()
    state, extra = restore(ckpt_dir, like={"params": out["params"], "opt": out["opt"]})
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(state), leaves({"params": out["params"], "opt": out["opt"]})))
    size = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    if not same or extra.get("next_step") != n_steps:
        raise AssertionError(f"checkpoint of step {n_steps} does not restore bit-equal "
                             f"(extra {extra})")
    log(f"[train] checkpoint of step {n_steps}: {size / 1e9:.2f} GB, restored bit-equal in "
        f"{t_restore:.1f} s")
    del state
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    add_launches(results, counts, "train")
    # where a step's time goes
    step = make_step_fn(model, opt_cfg)
    p, o = out["params"], out["opt"]
    data = token_batches(pipe, n_steps, model.device)
    b0 = next(data)

    def one_step():
        step(p, o, b0)
    rows, spans = profile_step(one_step, "rwkv6-1.6b training step, 8 x 512 tokens", top=12,
                               reps=1, spans=("rwkv6_backward", "rmsnorm_backward"))
    busy = sum(r[0] for r in rows) / 1e3
    fwd = sum(r[0] for r in rows if "rwkv6_kernel" in r[2]) / 1e3
    bwd_k = [r for r in rows if "wkv6_bwd_kernel" in r[2]]
    bwd_us, bwd_n = spans["rwkv6_backward"]
    gemm = sum(r[0] for r in rows if "gemm" in r[2].lower() or "nvjet" in r[2]) / 1e3
    if bwd_n != cfg.n_layers or sum(r[1] for r in bwd_k) != cfg.n_layers:
        raise AssertionError(f"a step ran the rwkv6 backward {bwd_n} times and its kernel "
                             f"{sum(r[1] for r in bwd_k)}, not {cfg.n_layers}")
    rms_us, rms_n = spans["rmsnorm_backward"]
    rms_fwd = sum(r[0] for r in rows if "rmsnorm" in r[2]) / 1e3
    log(f"[train] within a profiled step of {busy:.1f} ms device time: the rwkv6 forward "
        f"kernel {fwd:.2f} ms ({per_fwd} launches); the rwkv6 backward kernel "
        f"{sum(r[0] for r in bwd_k) / 1e3:.2f} ms ({cfg.n_layers} launches; its span "
        f"rwkv6_backward {bwd_us / 1e3:.2f} ms over {bwd_n} entries in key_averages(), which "
        f"leaves the kernel out of the span); the RMSNorm forward kernel {rms_fwd:.2f} ms, "
        f"its backward (span rmsnorm_backward) {rms_us / 1e3:.2f} ms over {rms_n} entries; "
        f"cuBLAS GEMMs {gemm:.1f} ms")


def phase_train_hybrid(results: dict, n_layers: int = 42, n_steps: int = 10,
                       warmup: int = 3) -> None:
    """zamba2-7b at every published width, cut in depth to ``n_layers``:
    42 layers are seven whole periods of the shared block (it fires after
    layers 0, 6, ..., 36), about half of the 81, what one of two pipeline
    stages would hold.  The whole model's params, grads and fp32 moments
    (~6.64 B parameters at 12 bytes, 79.6 GB) do not fit one 80 GB card.
    bf16 with per-block remat (the RunConfig defaults), random weights from
    seed 0, trained ``n_steps`` through the launcher's step function and
    Trainer on 8 x 512 TokenPipeline tokens, AdamW warmup 10, weight decay
    0.01, lr ``TRAIN_LR``; no checkpoint (the ``train`` phase holds the
    store).  The loss must be finite and fall on a held-out batch; one
    more step holds each kernel against its plain version on the trained
    weights."""
    import shutil
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.models.api import build_model
    from repro_torch.models.blocks import n_attn_applications
    from repro_torch.optim import adamw
    cfg, rcfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=n_layers), RunConfig()
    batch, seq = 8, 512
    model = build_model(cfg, rcfg, device="cuda")
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=n_steps,
                                weight_decay=0.01)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=rcfg.seed))
    held_out = next(token_batches(pipe, 100_000, model.device))     # a step the run never takes

    def eval_loss(p):
        with torch.no_grad():
            return model.loss(p, held_out)[0].item()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    numel = lambda tree: sum(t.numel() for t in leaves(tree))
    n_params, layer, shared = numel(params), numel(params["blocks"][0]), numel(params["shared"])
    n_fire = n_attn_applications(cfg)
    applied = n_layers * layer + n_fire * shared
    log(f"[train-hybrid] zamba2-7b cut to {n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}: {n_params} params ({n_params * 12 / 1e9:.1f} GB of bf16 params and "
        f"grads and fp32 moments; a Mamba2 layer {layer}, the shared block {shared}, fired "
        f"{n_fire} times: {applied} applied non-embedding params), bf16, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    loss_before = eval_loss(params)
    ckpt_dir = ROOT / "build" / "chip_smoke_train_hybrid"      # stays empty: no step saves
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out, counts, peak, wall, events = run_trainer(model, opt_cfg, pipe, params, n_steps,
                                                  ckpt_dir, ckpt_every=n_steps + 1)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = out["losses"]
    check_train_path(counts, HYBRID_TRAIN_PATH, "zamba2 training")
    per_fwd = 2 if rcfg.remat else 1
    if (counts["mamba2_ssd"] != n_layers * per_fwd * n_steps
            or counts["flash_attention"] != n_fire * per_fwd * n_steps or counts["rwkv6_scan"]):
        raise AssertionError(f"launches {counts}: a step must run the SSD kernel "
                             f"{n_layers * per_fwd} times and flash {n_fire * per_fwd} times "
                             f"({n_layers} layers, {n_fire} shared-block firings, remat "
                             f"{rcfg.remat}), and no rwkv6 kernel")
    loss_after = eval_loss(out["params"])
    if not all(np.isfinite(losses)) or not loss_after < loss_before:
        raise AssertionError(f"training losses {losses}, held-out loss {loss_before} -> "
                             f"{loss_after}: not finite or not falling")
    log_steps("train-hybrid", out, events, warmup, batch, seq, n_steps, loss_before, loss_after,
              applied, "applied non-embedding params (42 Mamba2 layers + 7 shared-block "
              "firings)", peak, wall)
    log(f"[train-hybrid] launches over the run: {counts}")
    add_launches(results, counts, "train_hybrid")
    step = make_step_fn(model, opt_cfg)
    p, o = out["params"], out["opt"]
    b0 = next(token_batches(pipe, n_steps, model.device))
    # each kernel of a step on the trained weights against its plain version
    served = check_served_kernels("zamba2-7b training step", lambda: step(p, o, b0),
                                  {k: n // n_steps for k, n in counts.items()})
    log(f"[train-hybrid] a step after the run, each kernel against its plain version at the "
        f"step's shapes (bf16 gate {BF16_TOL} x max(1, |ref|), the SSD's fp32 state "
        f"{SCAN_F32_TOL} x max|ref|): {served}")
    # where a step's time goes

    def one_step():
        step(p, o, b0)
    rows, spans = profile_step(one_step, f"zamba2-7b {n_layers}-layer training step, 8 x 512 "
                               f"tokens", top=12, reps=1,
                               spans=("mamba2_ssd_backward", "flash_attention_backward",
                                      "rmsnorm_backward", "train.forward", "train.adamw"))
    busy = sum(r[0] for r in rows) / 1e3
    fwd = sum(r[0] for r in rows if "ssd_kernel" in r[2]) / 1e3
    flash = sum(r[0] for r in rows if "flash_attention" in r[2]) / 1e3
    gemm = sum(r[0] for r in rows if "gemm" in r[2].lower() or "nvjet" in r[2]) / 1e3
    bwd_us, bwd_n = spans["mamba2_ssd_backward"]
    if bwd_n != n_layers:
        raise AssertionError(f"a step ran the SSD backward {bwd_n} times, not {n_layers}")
    fa_us, fa_n = spans["flash_attention_backward"]
    rms_us, rms_n = spans["rmsnorm_backward"]
    rms_fwd = sum(r[0] for r in rows if "rmsnorm" in r[2]) / 1e3
    if fa_n != n_fire:
        raise AssertionError(f"a step ran the flash backward {fa_n} times, not {n_fire}")
    log(f"[train-hybrid] within a profiled step of {busy:.1f} ms device time: the SSD forward "
        f"kernel {fwd:.2f} ms ({n_layers * per_fwd} launches); the SSD backward (autograd "
        f"through the plain version, span mamba2_ssd_backward) {bwd_us / 1e3:.1f} ms over "
        f"{bwd_n} entries ({bwd_us / 1e3 / bwd_n:.2f} ms each); the flash forward kernel "
        f"{flash:.2f} ms ({n_fire * per_fwd} launches), its backward (span "
        f"flash_attention_backward) {fa_us / 1e3:.1f} ms over {fa_n} entries "
        f"({fa_us / 1e3 / fa_n:.2f} ms each); the RMSNorm forward kernel {rms_fwd:.2f} ms, its "
        f"backward (span rmsnorm_backward) {rms_us / 1e3:.1f} ms over {rms_n} entries; cuBLAS "
        f"GEMMs {gemm:.1f} ms")
    # the backward's kernels are launched from autograd's own threads, which a
    # span of the main thread (train.backward) does not hold in key_averages
    fwd_ms, adamw_ms = spans["train.forward"][0] / 1e3, spans["train.adamw"][0] / 1e3
    log(f"[train-hybrid] the step's parts by the device time of the kernels launched in their "
        f"spans: forward {fwd_ms:.1f} ms, AdamW {adamw_ms:.1f} ms ({100 * adamw_ms / busy:.1f}% "
        f"of the step's {busy:.1f} ms), the rest (the backward with remat's recomputation) "
        f"{busy - fwd_ms - adamw_ms:.1f} ms")


# ---------------------------------------------------------------------------
# phases 14-15: the paper's training experiment (ResNet-34) and the
# pipeline-parallel LM trainer
# ---------------------------------------------------------------------------

RESNET_BATCH, RESNET_MB = 128, 16          # the paper's appendix A.1 setting: 8 x 16
# ResNet-34 gradients at 224 px x 4 images, fp32 against float64, worst leaf
# |err| / max(1, max|g|): the CPU reads 5.59e-3 and the card 7.82e-3 with TF32
# off, 1.54e-1 with cuDNN's default TF32 (PERF.md, PR 21).  The limit sits
# between the two card readings: TF32, or a wrong convolution, in the timed
# configuration fails it; the run checks that TF32 does.
RESNET_F64_TOL = 3e-2


def _resnet_grads(R, meta, params, x, y):
    from repro_torch.convert import leaves
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss = R.loss_fn(params, meta, x, y)
    return loss.detach(), torch.autograd.grad(loss, flat)


def _grad_err(got, ref) -> float:
    """Worst leaf error of gradients ``got`` against ``ref``, each leaf's max
    |diff| over max(1, max|ref|)."""
    return max((a.cpu().double() - b.double()).abs().max().item()
               / max(1.0, b.abs().max().item()) for a, b in zip(got, ref))


def phase_resnet(parity_px: int = 64, parity_batch: int = 2, reps: int = 3) -> None:
    """ResNet-34 (the paper's §4.1 model): the forward, loss and every
    gradient on the card against the CPU in fp32 on one set of params, at
    the CPU tests' size (``parity_px`` px, ``parity_batch`` images), and how
    far fp32 lies from float64 at 224 px on either device; the calibrated
    reproduction table beside the card's batch of 128 in 8 microbatches of
    16 at 224 px (forward, and forward + backward, by CUDA events, against
    the fp32 FLOP bound with TF32 off); and the reference bench's 2-stage
    cut at ``len(params) // 2`` with its max(s1, s2) x m + min(s1, s2)
    formula."""
    from repro_torch.configs.resnet34 import CONFIG
    from repro_torch.convert import move_params, tree_map
    from repro_torch.core import calibrate
    from repro_torch.data.synthetic import ImagePipeline
    from repro_torch.models import resnet as R
    meta, params = R.init_resnet(CONFIG, torch.Generator(device="cuda").manual_seed(0))
    p_cpu = move_params(params, "cpu")
    # card vs CPU, fp32, at the tests' size
    xs, ys = (torch.from_numpy(a) for a in
              ImagePipeline(CONFIG.n_classes, parity_px, parity_batch).batch_at(0))
    with torch.no_grad():
        lg = R.forward(meta, params, xs.cuda())
    lc = R.forward(meta, p_cpu, xs)
    logit_err = check_close("resnet34 logits", lg.cpu(), lc, MODEL_TOL, relative=True)
    l_g, g_g = _resnet_grads(R, meta, params, xs.cuda(), ys.cuda())
    l_c, g_c = _resnet_grads(R, meta, p_cpu, xs, ys)
    loss_err = abs(l_g.item() - l_c.item()) / abs(l_c.item())
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"resnet34 loss card {l_g.item()} vs CPU {l_c.item()}")
    for i, (a, ref) in enumerate(zip(g_g, g_c)):
        e = _grad_err([a], [ref])
        if not e <= GRAD_TOL:
            raise AssertionError(f"resnet34 gradient leaf {i}: {e:.3e} beyond {GRAD_TOL}")
    log(f"[resnet] ResNet-34 ({len(params)} blocks, {sum(t.numel() for t in g_c)} params), "
        f"fp32, {parity_batch} images of {parity_px} px, card vs CPU: logits worst "
        f"{logit_err:.2e} (tol {MODEL_TOL} x max(1, |ref|)); loss {l_g.item():.6f} vs "
        f"{l_c.item():.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_TOL}); {len(g_c)} gradient "
        f"leaves, worst {_grad_err(g_g, g_c):.2e} of max(1, max|g|) (tol {GRAD_TOL})")
    # fp32 against float64 at 224 px: the gradients' own conditioning
    xs, ys = (torch.from_numpy(a) for a in ImagePipeline(CONFIG.n_classes, CONFIG.img_size,
                                                         4).batch_at(0))
    g64 = _resnet_grads(R, meta, tree_map(lambda t: t.detach().double(), p_cpu), xs.double(),
                        ys)[1]
    card = lambda: _grad_err(_resnet_grads(R, meta, params, xs.cuda(), ys.cuda())[1], g64)
    err_off = card()
    torch.backends.cudnn.allow_tf32 = True         # cuDNN's default for fp32 convolutions
    err_tf32 = card()
    torch.backends.cudnn.allow_tf32 = False
    if not err_off <= RESNET_F64_TOL < err_tf32:
        raise AssertionError(f"resnet34 gradients at 224 px against float64: the card with "
                             f"TF32 off {err_off:.3e}, with TF32 {err_tf32:.3e}; the limit "
                             f"{RESNET_F64_TOL} must pass the first and fail the second")
    log(f"[resnet] 4 images of 224 px, gradients against the CPU's float64: the CPU in fp32 "
        f"worst {_grad_err(_resnet_grads(R, meta, p_cpu, xs, ys)[1], g64):.2e}, the card in fp32 "
        f"with TF32 off {err_off:.2e} (limit {RESNET_F64_TOL}; with cuDNN's default TF32 "
        f"{err_tf32:.2e}, which the limit refuses) of max(1, max|g|): fp32's own error at "
        f"this size, where the {GRAD_TOL} gate would not hold on either device")
    del p_cpu, g_g, g_c, g64
    x, y = (torch.from_numpy(a).cuda() for a in
            ImagePipeline(CONFIG.n_classes, CONFIG.img_size, RESNET_BATCH).batch_at(0))
    # the batch of 128 in 8 microbatches of 16, on the card
    m = RESNET_BATCH // RESNET_MB
    mbs = [(x[i * RESNET_MB:(i + 1) * RESNET_MB], y[i * RESNET_MB:(i + 1) * RESNET_MB])
           for i in range(m)]

    def fwd_batch():
        with torch.no_grad():
            for xm, _ in mbs:
                R.forward(meta, params, xm)

    def train_batch():
        for xm, ym in mbs:
            _resnet_grads(R, meta, params, xm, ym)
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = sync_time_ms([fwd_batch], iters=reps, warmup=1)
    train_ms = sync_time_ms([train_batch], iters=reps, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    profile_step(lambda: _resnet_grads(R, meta, params, *mbs[0]), "ResNet-34 training "
                 f"microbatch of {RESNET_MB} at 224 px, fp32", top=8, reps=2)
    costs = R.block_costs(CONFIG, meta, params, RESNET_MB)
    fwd_flops = sum(f for f, _ in costs) * m
    bound_ms = 3 * fwd_flops / PEAK_F32_FLOPS * 1e3
    rows = calibrate.reproduction_table()
    for r in rows:
        log(f"[resnet] reproduction {r['setup']:20s} predicted {r['predicted_s']:.3f} s, paper "
            f"{r['paper_s']:.3f} s, rel_err {r['rel_err']:.3f}"
            f"{' (held out)' if r['held_out'] else ''}")
    log(f"[resnet] this card, batch {RESNET_BATCH} in {m} microbatches of {RESNET_MB}, fp32 "
        f"(TF32 off), {reps} batches after a warm-up: training (forward + backward) "
        f"{train_ms / 1e3:.4f} s a batch ({train_ms / m:.3f} ms a microbatch; bound "
        f"{bound_ms:.1f} ms at {3 * fwd_flops:.4e} FLOPs / {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s "
        f"fp32, {bound_ms / train_ms:.3f} of it; {3 * fwd_flops / (train_ms / 1e3) / 1e12:.2f} "
        f"TFLOP/s); inference {fwd_ms / 1e3:.4f} s a batch ({fwd_ms / m:.3f} ms a microbatch, "
        f"bound {bound_ms / 3:.1f} ms); against the paper's desktop alone "
        f"{calibrate.PAPER_MS['desktop_alone'] / 1e3:.3f} s and inference "
        f"{calibrate.PAPER_MS['desktop_alone_infer'] / 1e3:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    # the reference bench's 2-stage cut (forward only, one microbatch)
    cut = len(params) // 2
    xm = mbs[0][0]
    with torch.no_grad():
        h = R.forward(meta, params, xm, upto=cut)

        def s1():
            R.forward(meta, params, xm, upto=cut)

        def s2():
            R.forward(meta, params, h, start=cut)

        def full():
            R.forward(meta, params, xm)
        t1, t2, tf = (sync_time_ms([f], iters=20) for f in (s1, s2, full))
    pipe = max(t1, t2) * m + min(t1, t2)
    log(f"[resnet] 2-stage cut before block {cut} of {len(params)} (boundary "
        f"{costs[cut - 1][1] / 1e6:.1f} MB a microbatch of {RESNET_MB}): stage 1 {t1:.3f} ms, "
        f"stage 2 {t2:.3f} ms, unsplit {tf:.3f} ms a microbatch; 2 devices pipelined "
        f"(max x {m} + min) {pipe / m:.3f} ms a microbatch, {tf / (pipe / m):.2f}x the unsplit "
        f"forward")


def _wkv6_f64(r, k, v, log_w, u) -> torch.Tensor:
    """The WKV6 token recurrence in float64 (out only)."""
    b, t, h, dk = r.shape
    s = torch.zeros((b, h, dk, dk), dtype=torch.float64, device=r.device)
    rf, kf, vf, wf = (a.double() for a in (r, k, v, torch.exp(log_w.double())))
    uf = u.double()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1)


def pp_launches(cfg, g, schedule: str, remat: bool, bf16: bool) -> dict:
    """Kernel launches of one pipelined step: every layer's forward kernels
    once per forward its (stage, microbatch) runs -- with grad, plus remat's
    recompute, plus, on the hybrid's stages before the last, the forward of
    the F tick -- and the final norm once per microbatch, over the R replica
    columns of the one data replica the phase's (1, 2) mesh has; in bf16
    (``bf16``) an rwkv6 layer's backward kernel once per (stage, microbatch)
    (the other backwards run the plain versions)."""
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import is_recurrent
    layer = ({"rwkv6_scan": 1, "rmsnorm": 2} if cfg.rwkv else
             {"mamba2_ssd": 1, "rmsnorm": 2} if is_recurrent(cfg) else
             {"flash_attention": 1, "rmsnorm": 2})
    shared = {"flash_attention": 1, "rmsnorm": 2}
    want = dict.fromkeys(ops.launch_counts(), 0)
    cols = g.M * g.R
    for s in range(g.S):
        fwds = 1 + int(remat) + int(schedule == "hybrid" and s < g.S - 1)
        for idx in range(s * g.lps, min((s + 1) * g.lps, cfg.n_layers)):
            fire = [shared] if cfg.attn_every and idx % cfg.attn_every == 0 else []
            for kern in [layer] + fire:
                for name, n in kern.items():
                    want[name] += n * fwds * cols
            if cfg.rwkv and bf16:
                want["rwkv6_scan_bwd"] += cols
    want["rmsnorm"] += cols
    return want


def phase_train_pp(results: dict, n_steps: int = 10, n_warm: int = 10,
                   warmup: int = 3) -> None:
    """The pipelined trainer (``core/pipeline.py``) on the card.  First the
    pipelined step against the unsplit step of the launcher on one set of
    fp32 params, for gpipe and hybrid on an emulated (1, 2) mesh (2 stages):
    granite-8b and rwkv6-1.6b at full width cut to 4 layers, zamba2-7b at
    full width cut to 12 (its shared block fires in both stages), 4 x 128
    tokens in 2 microbatches: loss, every gradient leaf, grad_norm and the
    losses of 3 AdamW steps, each kernel's launches exact, and in the hybrid
    step every kernel held against its plain version at the shapes it gets.
    Then rwkv6-1.6b at full width and depth, bf16 with remat: the
    launcher's unsplit step warms it up for ``n_warm`` steps with the
    ``train`` phase's AdamW (the loss rises over the warm-up, split or not)
    and gives the unsplit step time; the hybrid pipelined step over 2
    stages, 4 microbatches of 2 x 512 tokens, continues the same schedule
    for ``n_steps`` through the launcher's Trainer.  One pipelined step
    holds every kernel against its plain version; over the Trainer's run
    the loss falls on a held-out batch and the kernel launches are exact;
    a profiled step gives the device's busy share."""
    import shutil
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.convert import leaves, tree_map
    from repro_torch.core import schedules
    from repro_torch.core.pipeline import make_pp_train_step
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as krwkv
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh((1, 2))
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="const", weight_decay=0.0)
    for arch, n_layers in (("granite-8b", 4), ("rwkv6-1.6b", 4), ("zamba2-7b", 12)):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        shape = ShapeConfig("parity", 128, 4, "train")
        rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                         microbatches=2)
        model = build_model(cfg, rcfg, device="cuda")
        p0 = model.init(0)
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                                        global_batch=shape.global_batch))
        batches = [next(token_batches(pipe, i, "cuda")) for i in range(3)]
        l_ref, g_ref = _loss_and_grads(model, p0, batches[0]["tokens"])
        params, step = clone(p0), make_step_fn(model, opt_cfg)
        opt, ref_losses, ref_norms = adamw.init(params), [], []
        for b in batches:
            params, opt, met = step(params, opt, b)
            ref_losses.append(met["loss"].item())
            ref_norms.append(met["grad_norm"].item())
        del params, opt
        for schedule in ("gpipe", "hybrid"):
            built = make_pp_train_step(cfg, shape, dataclasses.replace(rcfg, schedule=schedule),
                                       mesh, opt_cfg, device="cuda")
            g, sch = built["geometry"], built["schedule"]
            pp = built["to_pipeline"](clone(p0))
            want = pp_launches(cfg, g, schedule, rcfg.remat, bf16=False)
            ops.reset_launch_counts()
            if schedule == "hybrid":
                out = {}
                served = check_served_kernels(f"{arch} {schedule} pipelined step",
                                              lambda: out.update(r=sch(pp, batches[0])), want)
                loss, grads = out.pop("r")
            else:
                loss, grads = sch(pp, batches[0])
            counts = ops.launch_counts()
            check_launches(counts, want, f"{arch} {schedule} pipelined step")
            loss_err = abs(loss.item() - l_ref.item()) / abs(l_ref.item())
            if not loss_err <= TRAIN_LOSS_TOL:
                raise AssertionError(f"{arch} {schedule} loss {loss.item()} vs unsplit "
                                     f"{l_ref.item()}")
            grad_err = 0.0
            for i, (a, ref) in enumerate(zip(leaves(grads), g_ref)):
                e = (a - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                if not e <= GRAD_TOL:
                    raise AssertionError(f"{arch} {schedule} gradient leaf {i}: {e:.3e}")
                grad_err = max(grad_err, e)
            del grads
            opt, losses, norms = adamw.init(pp), [], []
            for b in batches:
                pp, opt, met = built["fn"](pp, opt, b)
                losses.append(met["loss"].item())
                norms.append(met["grad_norm"].item())
            norm_err = abs(norms[0] - ref_norms[0]) / ref_norms[0]
            step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            if not (norm_err <= TRAIN_LOSS_TOL and step_err <= STEP_LOSS_TOL):
                raise AssertionError(f"{arch} {schedule}: grad_norm {norms[0]} vs {ref_norms[0]}, "
                                     f"AdamW losses {losses} vs {ref_losses}")
            log(f"[train-pp] {arch} (d_model {cfg.d_model}, {n_layers} layers) {schedule}, fp32, "
                f"S={g.S} M={g.M} x {g.b_mb} x {shape.seq_len} tokens vs the unsplit step: loss "
                f"rel {loss_err:.2e} (tol {TRAIN_LOSS_TOL}), {len(g_ref)} gradient leaves worst "
                f"{grad_err:.2e} of max(1, max|g|) (tol {GRAD_TOL}), grad_norm rel "
                f"{norm_err:.2e}, 3 AdamW steps' losses worst rel {step_err:.2e} (tol "
                f"{STEP_LOSS_TOL}); launches {counts}")
            if schedule == "hybrid":
                log(f"[train-pp] {arch} hybrid, each kernel against its plain version at the "
                    f"step's shapes (fp32 gate {SCAN_F32_TOL} x max|ref|): {served}")
            del pp, opt
        del p0, g_ref
        torch.cuda.empty_cache()
    # rwkv6-1.6b at full width and depth, bf16, remat: warmed up by the
    # unsplit step, then trained by the hybrid pipelined step over 2 stages
    cfg, rcfg = get_config("rwkv6-1.6b"), RunConfig(schedule="hybrid", microbatches=4)
    batch, seq = 8, 512
    shape = ShapeConfig("train_pp", seq, batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=n_warm + n_steps,
                                weight_decay=0.01)
    built = make_pp_train_step(cfg, shape, rcfg, mesh, opt_cfg, device="cuda")
    model, g, sch = built["model"], built["geometry"], built["schedule"]
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    seed=rcfg.seed))
    held_out = next(token_batches(pipe, 100_000, "cuda"))

    def eval_loss(p):
        with torch.no_grad():
            return model.loss(built["from_pipeline"](p), held_out)[0].item()
    p, step = model.init(0), make_step_fn(model, opt_cfg)
    o, data, times = adamw.init(p), token_batches(pipe, 0, "cuda"), []
    for _ in range(n_warm):
        b = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, met = step(p, o, b)
        met["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    un_ms = float(np.median(times[2:]))
    params = built["to_pipeline"](p)
    opt = dict(m=built["to_pipeline"](o["m"]), v=built["to_pipeline"](o["v"]), step=o["step"])
    del p, o, data
    loss_before = eval_loss(params)
    per_step = pp_launches(cfg, g, "hybrid", rcfg.remat, bf16=rcfg.compute_dtype == "bfloat16")
    b0 = next(token_batches(pipe, n_warm, "cuda"))
    worst = {}
    served = check_served_kernels("rwkv6-1.6b pipelined step", lambda: sch(params, b0), per_step,
                                  worst_args=worst)
    # the WKV6 call farthest from the plain version, against the float64
    # recurrence: a trained model's state reaches ~1e4 while out rows cancel
    # to O(1), where the kernel's inter term needs fp32's 24 bits
    args = worst.pop("rwkv6_scan")
    f64 = _wkv6_f64(*args)
    f64_margin = gate(krwkv.rwkv6_cuda(*args), f64, BF16_TOL, True)
    plain_margin = gate(krwkv.rwkv6_chunked_plain(*args), f64, BF16_TOL, True)
    if not f64_margin <= 1.0:
        raise AssertionError(f"rwkv6 kernel against the float64 recurrence in the pipelined "
                             f"step: margin {f64_margin:.3f}")
    # the backward kernel on that call's inputs (a seeded output gradient)
    # against the plain VJP, and both against the float64 recurrence's
    gout = _rand(args[0].shape, torch.bfloat16, torch.Generator(device="cuda").manual_seed(0))
    names = ("dr", "dk", "dv", "dlog_w", "du")
    kb, pb = krwkv.rwkv6_bwd_cuda(*args, gout), _wkv6_plain_vjp(*args, gout)
    with torch.enable_grad():
        xs = [a.detach().double().requires_grad_(True) for a in args]
        f64b = torch.autograd.grad(_wkv6_f64(*xs), xs, gout.double())
    bwd_margins = check_gates("rwkv6 backward kernel against the plain VJP in the pipelined "
                              "step", {n: gate(a, e, BF16_TOL, True)
                                       for n, a, e in zip(names, kb, pb)})
    f64_bwd = ", ".join(f"{n} {gate(a, e, BF16_TOL, True):.3f} / "
                        f"{gate(q, e, BF16_TOL, True):.3f}" for n, a, q, e in zip(names, kb, pb, f64b))
    log(f"[train-pp] rwkv6-1.6b pipelined step (bf16, remat, hybrid), each kernel against its "
        f"plain version at the step's shapes (bf16 gate {BF16_TOL} x max(1, |ref|)): {served}; "
        f"the WKV6 call farthest from it against the float64 recurrence (max|ref| "
        f"{f64.abs().max().item():.4g}): kernel margin {f64_margin:.3f}, plain version "
        f"{plain_margin:.3f}; the backward kernel on that call against the plain VJP: "
        f"{bwd_margins}; against the float64 recurrence's gradients, kernel / plain VJP: "
        f"{f64_bwd}")
    del worst, args, f64, kb, pb, f64b, xs, gout
    events = []

    def on_metrics(step, rec):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    ckpt_dir = ROOT / "build" / "chip_smoke_train_pp"          # stays empty: no step saves
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tr = Trainer(TrainerConfig(total_steps=n_steps, ckpt_every=n_steps + 1,
                               ckpt_dir=str(ckpt_dir), log_every=5),
                 built["fn"], lambda: (params, opt),
                 lambda start: token_batches(pipe, n_warm + start, "cuda"),
                 on_metrics=on_metrics)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = ops.launch_counts(), torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check_launches(counts, {k: n * n_steps for k, n in per_step.items()},
                   f"rwkv6-1.6b pipelined training, {n_steps} steps")
    losses = out["losses"]
    loss_after = eval_loss(out["params"])
    if not all(np.isfinite(losses)) or not loss_after < loss_before:
        raise AssertionError(f"pipelined training losses {losses}, held-out loss "
                             f"{loss_before} -> {loss_after}: not finite or not falling")
    n_params = sum(t.numel() for t in leaves(out["params"]))
    n_embed = out["params"]["embed"]["tok"].numel() + out["params"]["head"]["w"].numel()
    trace = sch.trace
    stats = schedules.schedule_stats(sch.table, g.S, g.M)
    log(f"[train-pp] rwkv6-1.6b {cfg.n_layers} layers, bf16, remat, hybrid: S={g.S} stages of "
        f"{g.lps} layers, R={g.R}, M={g.M} microbatches of {g.b_mb} x {seq} tokens; "
        f"{stats['ticks']} ticks, bubble {stats['bubble_fraction']:.4f} (schedule_stats); "
        f"boundary bytes per tick {trace.tick_bytes[0]}, stash peak {trace.stash_peak} B "
        f"(stage 0 stashes token ids and re-embeds); launches per step {per_step}; steps "
        f"{n_warm + 1}-{n_warm + n_steps} of the schedule, after {n_warm} unsplit steps")
    log_steps("train-pp", out, events, warmup, batch, seq, n_steps, loss_before, loss_after,
              n_params - n_embed, "non-embedding params", peak, wall)
    add_launches(results, counts, "train_pp")
    pp_ms = float(np.median([r["step_s"] * 1e3 for r in out["history"][warmup:]]))
    p, o = out["params"], out["opt"]
    profile_step(lambda: built["fn"](p, o, b0), "rwkv6-1.6b pipelined training step (hybrid, "
                 f"S={g.S}, M={g.M} x {g.b_mb} x {seq} tokens)", top=8, reps=1)
    log(f"[train-pp] step median {pp_ms:.1f} ms pipelined (hybrid, S={g.S}, M={g.M}; steps "
        f"{warmup + 1}-{n_steps} of its run) against {un_ms:.1f} ms unsplit (the launcher's "
        f"step on the same model and batch shape, median of warm-up steps 3-{n_warm}; all "
        f"{', '.join(f'{t:.1f}' for t in times)}): {pp_ms / un_ms:.2f}x")


# ---------------------------------------------------------------------------
# phases 23-25: the GSPMD strategies, full-width training through them, and
# the production-mesh dry-run
# ---------------------------------------------------------------------------

GSPMD_OPT = dict(lr=1e-2, warmup_steps=0, schedule="const", weight_decay=0.0)


def gspmd_launches(cfg, strategy: str, n_mb: int, remat: bool) -> dict:
    """Kernel launches of one GSPMD step (forward kernels; the backwards run
    the plain versions) over ``n_mb`` microbatches: every layer's kernels
    once per forward (twice under remat: its recompute) and the final norms
    once a microbatch.  A dense or MoE layer: flash once, RMSNorm twice;
    whisper: an encoder layer flash once and RMSNorm twice, a decoder layer
    flash twice (self and cross) and RMSNorm three times, plus the encoder's
    and the decoder's final norms.  gspmd_pp's loss is the mean of the
    model's loss over its microbatches, so each microbatch passes every
    real layer once."""
    from repro_torch.kernels import ops
    want = dict.fromkeys(ops.launch_counts(), 0)
    f = 1 + int(remat)
    if cfg.n_enc_layers:
        want["flash_attention"] = n_mb * f * (cfg.n_enc_layers + 2 * cfg.n_layers)
        want["rmsnorm"] = n_mb * (f * (2 * cfg.n_enc_layers + 3 * cfg.n_layers) + 2)
    else:
        want["flash_attention"] = n_mb * f * cfg.n_layers
        want["rmsnorm"] = n_mb * (f * 2 * cfg.n_layers + 1)
    return want


def _gspmd_grads(built, params, batch, opt_cfg):
    """One step of ``built["fn"]`` from ``params`` (updated in place) and a
    fresh AdamW state: (metrics as floats, the step's gradient leaves read
    back from its first moment, ``m = (1 - b1) x clip(g)``)."""
    from repro_torch.convert import leaves
    from repro_torch.optim import adamw
    _, opt, met = built["fn"](params, adamw.init(params), batch)
    met = {k: v.item() for k, v in met.items()}
    scale = min(1.0, opt_cfg.clip_norm / (met["grad_norm"] + 1e-9))
    return met, [m / ((1 - opt_cfg.b1) * scale) for m in leaves(opt["m"])]


def _mean_loss_grads(model, params, batches):
    """The unsplit model's loss and gradients (the launcher's: ``model.loss``
    by autograd), averaged over ``batches``."""
    from repro_torch.convert import leaves
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss, grads = 0.0, None
    for b in batches:
        lb, _ = model.loss(params, b)
        g = torch.autograd.grad(lb, flat)
        grads = list(g) if grads is None else [a + c for a, c in zip(grads, g)]
        loss += lb.item()
    return loss / len(batches), [g / len(batches) for g in grads]


def _gate_grads(got, ref, what: str) -> float:
    """``_grad_err`` of gradients ``got`` against ``ref`` (either device),
    raised on past GRAD_TOL; returns it."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} gradient leaves vs {len(ref)}")
    err = _grad_err(got, [r.cpu() for r in ref])
    if not err <= GRAD_TOL:
        raise AssertionError(f"{what}: gradients {err:.3e} of max(1, max|g|) beyond {GRAD_TOL}")
    return err


def _gspmd_batch(cfg, batch: int, seq: int, device: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                                  dtype=np.int32))}
    if cfg.n_enc_layers:
        out["frames"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in out.items()}


def phase_parity_gspmd() -> None:
    """The GSPMD strategies on the card in fp32 (TF32 off), each against
    the port's own unsplit step (``model.loss`` by autograd) on the card from
    the same params: gspmd_tp at grad_accum 2 on reduced whisper-small and
    reduced llama4 (the unsplit loss and gradients averaged over the same
    two contiguous row blocks, so MoE capacity sees the same groups), also
    held to the same step on the CPU; gspmd_pp on an emulated (4, 1) mesh on
    reduced grok-1 and llama4 at 8 layers (4 microbatches; the unsplit step
    averaged over them), also held to the CPU, and on granite-8b at full
    width cut to 4 layers.  Loss within TRAIN_LOSS_TOL relative, each
    gradient leaf (read back from the step's first moment) within GRAD_TOL
    x max(1, max|g|), launches exact, ``meta`` equal to the CPU build's; the
    MoE runs print the smallest top-k gap."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config, reduced_config
    from repro_torch.convert import move_params, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(**GSPMD_OPT)
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)

    def red(arch, n=0):
        cfg = reduced_config(get_config(arch))
        return dataclasses.replace(cfg, n_layers=n) if n else cfg
    # (what, config, strategy, mesh, batch, seq, also on the CPU)
    cases = [("whisper-small reduced", red("whisper-small"), "gspmd_tp", (1, 1), 8, 32, True),
             ("llama4-scout reduced", red("llama4-scout-17b-a16e"), "gspmd_tp", (1, 1), 8, 64,
              True),
             ("grok-1 reduced, 8 layers", red("grok-1-314b", 8), "gspmd_pp", (4, 1), 8, 32, True),
             ("llama4-scout reduced, 8 layers", red("llama4-scout-17b-a16e", 8), "gspmd_pp",
              (4, 1), 8, 64, True),
             ("granite-8b full width, 4 layers",
              dataclasses.replace(get_config("granite-8b"), n_layers=4), "gspmd_pp", (4, 1), 4,
              128, False)]
    for what, cfg, strategy, mesh_shape, batch, seq, on_cpu in cases:
        tp = strategy == "gspmd_tp"
        rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                         strategy=strategy, grad_accum=2 if tp else 1,
                         microbatches=0 if tp or batch < 8 else 4)
        shape = ShapeConfig("parity", seq, batch, "train")
        mesh = make_host_mesh(mesh_shape)
        built = make_train_step(cfg, shape, rcfg, mesh, opt_cfg, device="cuda")
        cpu_built = make_train_step(cfg, shape, rcfg, mesh, opt_cfg, device="cpu")
        meta = built["meta"]
        if meta != cpu_built["meta"]:
            raise AssertionError(f"{what}: meta {meta} vs the CPU build's {cpu_built['meta']}")
        to_pp = built.get("to_pipeline", lambda p: p)
        model = built["model"]
        p0 = model.init(0)
        b = _gspmd_batch(cfg, batch, seq, "cuda")
        n_mb = meta["accum"] if tp else meta["M"]
        rows = batch // n_mb
        mbs = [{k: v[i * rows:(i + 1) * rows] for k, v in b.items()} for i in range(n_mb)]
        l_ref, g_ref = _mean_loss_grads(model, clone(p0), mbs)
        with MoeRecorder(check=False) as rec:
            ops.reset_launch_counts()
            # the stage-slot layout's leaves come in the layer list's order
            met, grads = _gspmd_grads(built, to_pp(clone(p0)), b, opt_cfg)
            counts = ops.launch_counts()
        check_launches(counts, gspmd_launches(cfg, strategy, n_mb, remat=False),
                       f"{what} {strategy} step")
        loss_err = abs(met["loss"] - l_ref) / abs(l_ref)
        if not loss_err <= TRAIN_LOSS_TOL:
            raise AssertionError(f"{what} {strategy} loss {met['loss']} vs unsplit {l_ref}")
        grad_err = _gate_grads(grads, g_ref, f"{what} {strategy} vs unsplit")
        cpu_note = ""
        if on_cpu:
            met_c, g_c = _gspmd_grads(cpu_built, to_pp(move_params(p0, "cpu")),
                                      _gspmd_batch(cfg, batch, seq, "cpu"), opt_cfg)
            c_err = abs(met["loss"] - met_c["loss"]) / abs(met_c["loss"])
            if not c_err <= TRAIN_LOSS_TOL:
                raise AssertionError(f"{what} {strategy} loss card {met['loss']} vs CPU "
                                     f"{met_c['loss']}")
            cg_err = _gate_grads(grads, g_c, f"{what} {strategy} card vs CPU")
            cpu_note = (f"; against the same step on the CPU: loss rel {c_err:.2e}, gradients "
                        f"worst {cg_err:.2e}")
        moe = f"; MoE: {rec.summary()}" if cfg.n_experts else ""
        log(f"[parity-gspmd] {what} (d_model {cfg.d_model}, {cfg.n_layers} layers), {strategy} "
            f"on {mesh_shape}, fp32, {batch} x {seq} tokens: meta {meta}; loss {met['loss']:.6f} "
            f"vs the unsplit step's {l_ref:.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_TOL}), aux "
            f"{met['aux']:.6f}; {len(g_ref)} gradient leaves worst {grad_err:.2e} of max(1, "
            f"max|g|) (tol {GRAD_TOL}){cpu_note}; launches {nonzero(counts)}{moe}")
        del built, cpu_built, model, p0, g_ref, grads
        gc.collect()
        torch.cuda.empty_cache()


# the full-width GSPMD training runs: (arch, layers (0: all), the strategy
# asked for, the strategy it must resolve to, mesh, batch, seq, steps)
GSPMD_RUNS = (("whisper-small", 0, "auto", "gspmd_tp", (1, 1), 8, 448, 10),
              ("granite-8b", 8, "gspmd_pp", "gspmd_pp", (4, 1), 8, 512, 10),
              ("llama4-scout-17b-a16e", 1, "auto", "gspmd_pp", (2, 1), 8, 512, 5))


def phase_train_gspmd(results: dict, warmup: int = 3) -> None:
    """Full-width training through the GSPMD step builders, bf16 with remat
    (the RunConfig defaults), random weights from seed 0, AdamW at lr
    TRAIN_LR (warmup 3, weight decay 0.01), through the Trainer on
    TokenPipeline batches (whisper's with FrontendPipeline frames):
    whisper-small at full depth by its ``auto`` strategy (gspmd_tp) at
    grad_accum 2; granite-8b cut to 8 of 36 layers by gspmd_pp on an
    emulated (4, 1) mesh (S=4, 2 layers a stage, M=8); llama4-scout cut to 1
    of 48 layers by its ``auto`` strategy (gspmd_pp) on (2, 1), its stage 1
    the pad slot.  Each run: launches exact, finite training losses and aux,
    a held-out loss that falls over the run, the step
    (trainer's clock and card events, median after ``warmup``), tok/s, MFU
    (6 N D over non-embedding active params, and the analytic model's
    FLOPs without remat), peak memory, a profiled step's busy share, and
    every kernel held against its plain version at the step's shapes (one
    forward)."""
    import shutil
    from repro_torch.analysis.analytic import step_flops
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.convert import leaves
    from repro_torch.data.synthetic import DataConfig, FrontendPipeline, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import token_batches
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    for arch, n_layers, strategy, resolved, mesh_shape, batch, seq, n_steps in GSPMD_RUNS:
        t_build = time.perf_counter()
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        rcfg = RunConfig(strategy=strategy, grad_accum=2 if cfg.n_enc_layers else 1)
        shape = ShapeConfig("train_gspmd", seq, batch, "train")
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=3, total_steps=n_steps,
                                    weight_decay=0.01)
        built = make_train_step(cfg, shape, rcfg, make_host_mesh(mesh_shape), opt_cfg,
                                device="cuda")
        meta, model = built["meta"], built["model"]
        if meta["strategy"] != resolved:
            raise AssertionError(f"{arch}: strategy {strategy!r} resolved to "
                                 f"{meta['strategy']}, expected {resolved}")
        to_pp = built.get("to_pipeline", lambda p: p)
        from_pp = built.get("from_pipeline", lambda p: p)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          seed=rcfg.seed)
        pipe = (FrontendPipeline(dcfg, cfg.frontend_seq, cfg.d_model, key="frames")
                if cfg.n_enc_layers else TokenPipeline(dcfg))
        held_out = next(token_batches(pipe, 100_000, "cuda"))

        def eval_loss(p):
            with torch.no_grad():
                return model.loss(from_pp(p), held_out)[0].item()
        params = to_pp(model.init(0))
        n_params = sum(t.numel() for t in leaves(params))
        loss_before = eval_loss(params)
        n_mb = meta.get("accum") or meta["M"]
        per_step = gspmd_launches(cfg, meta["strategy"], n_mb, rcfg.remat)
        # every kernel against its plain version at the step's shapes: one forward
        fwd = (lambda: built["loss_fn"](params, held_out)) if "loss_fn" in built else \
            (lambda: model.loss(params, held_out))
        with torch.no_grad():
            served = check_served_kernels(f"{arch} {meta['strategy']} forward", fwd,
                                          gspmd_launches(cfg, meta["strategy"],
                                                         n_mb if "loss_fn" in built else 1,
                                                         False))
        events = []

        def on_metrics(step, rec):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        ckpt_dir = ROOT / "build" / "chip_smoke_train_gspmd"      # stays empty: no step saves
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        aux = []
        step_fn = built["fn"]

        def counted(p, o, b):
            p, o, met = step_fn(p, o, b)
            aux.append(met["aux"])
            return p, o, met
        tr = Trainer(TrainerConfig(total_steps=n_steps, ckpt_every=n_steps + 1,
                                   ckpt_dir=str(ckpt_dir), log_every=5),
                     counted, lambda: (params, adamw.init(params)),
                     lambda start: token_batches(pipe, start, "cuda"), on_metrics=on_metrics)
        set_up = time.perf_counter() - t_build
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, peak = ops.launch_counts(), torch.cuda.max_memory_allocated()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        check_launches(counts, {k: n * n_steps for k, n in per_step.items()},
                       f"{arch} {meta['strategy']} training, {n_steps} steps")
        losses = out["losses"]
        aux = [a.item() for a in aux]
        loss_after = eval_loss(out["params"])
        # the held-out batch is the same before and after; each training
        # loss is another batch's
        if not (all(np.isfinite(losses)) and all(np.isfinite(aux)) and
                loss_after < loss_before):
            raise AssertionError(f"{arch} {meta['strategy']} training losses {losses}, aux "
                                 f"{aux}, held-out loss {loss_before} -> {loss_after}: not "
                                 f"finite or not falling")
        useful = cfg.active_params() - cfg.embed_params()
        log(f"[train-gspmd] {arch} (d_model {cfg.d_model}, {cfg.n_layers} layers), bf16, remat, "
            f"{meta['strategy']} on {mesh_shape}: meta {meta}; {n_params / 1e9:.3f} B params "
            f"held ({useful / 1e9:.3f} B non-embedding active); set-up {set_up:.1f} s; "
            f"launches per step {nonzero(per_step)}; each kernel against its plain version at "
            f"the step's shapes (bf16 gate {BF16_TOL} x max(1, |ref|)): {served}; aux per step "
            f"{', '.join(f'{a:.4f}' for a in aux)}")
        log_steps("train-gspmd", out, events, warmup, batch, seq, n_steps, loss_before,
                  loss_after, useful, "non-embedding active params", peak, wall)
        step_ms = float(np.median([r["step_s"] * 1e3 for r in out["history"][warmup:]]))
        analytic = step_flops(cfg, shape, remat=False)
        log(f"[train-gspmd] {arch}: analytic step FLOPs without remat {analytic:.4e} "
            f"(encoder frames and attention included) -> {analytic / (step_ms / 1e3) / 1e12:.1f} "
            f"TFLOP/s, {analytic / (step_ms / 1e3) / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s bf16")
        add_launches(results, counts, f"train_gspmd_{arch}")
        p, o, b0 = out["params"], out["opt"], held_out
        profile_step(lambda: step_fn(p, o, b0), f"{arch} {meta['strategy']} training step "
                     f"({batch} x {seq} tokens)", top=8, reps=1, share="flash_attention")
        del built, model, params, out, p, o, tr, step_fn
        gc.collect()
        torch.cuda.empty_cache()


def phase_dryrun() -> None:
    """The analytic dry-run (``launch/dryrun.py``) over every arch x shape on
    both production meshes, then the roofline (``analysis/roofline.py``)
    with the H100-mesh profile (datasheet figures, ``hw/specs.py``): ok /
    skip counts, the cells whose peak fits 80 GB, each cell's dominant
    term.  Host only; artifacts under build/chip_smoke_dryrun."""
    import shutil
    from repro_torch.analysis.roofline import best_rows
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun
    out = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    cells = [dryrun.run_cell(a, s, mp, out_dir=out, verbose=False)
             for a in ARCH_IDS for s in SHAPES for mp in (False, True)]
    took = time.perf_counter() - t0
    n = {st: sum(c["status"] == st for c in cells) for st in ("ok", "skip", "error")}
    if n["error"]:
        bad = [(c["arch"], c["shape"], c["mesh"], c["error"]) for c in cells
               if c["status"] == "error"]
        raise AssertionError(f"dry-run cells failed: {bad}")
    fits = sum(bool(c.get("fits_h100_80gb")) for c in cells)
    rows = best_rows(cells)
    dominant = {}
    for key in sorted(rows):
        row = rows[key]
        if row.status != "ok":
            continue
        dominant[row.dominant] = dominant.get(row.dominant, 0) + 1
        log(f"[dryrun] {'/'.join(key)} ({row.strategy}): compute {row.compute_s * 1e3:.2f} ms, "
            f"memory {row.memory_s * 1e3:.2f} ms, collective {row.collective_s * 1e3:.2f} ms "
            f"-> {row.dominant}; peak {row.peak_gb:.2f} GB/device; useful {row.useful_ratio:.3f}")
    log(f"[dryrun] {len(cells)} cells in {took:.2f} s: {n['ok']} ok, {n['skip']} skipped; "
        f"{fits} of the ok cells fit one 80 GB H100; dominant terms {dominant} (H100-mesh "
        f"datasheet profile; activations, HBM traffic and collectives are estimates)")


def _train_losses(cfg, rcfg, lr: float, n_steps: int, batch: int, seq: int, device: str,
                  params=None, frozen: str = "") -> list:
    """Per-step losses of the launcher's step function from seed-0 weights
    (or ``params``) on TokenPipeline batches, AdamW as the reference
    launcher sets it (warmup 10, weight decay 0.01) at ``lr``; the
    top-level param group ``frozen`` is put back after every step."""
    from repro_torch.data.synthetic import DataConfig, TokenPipeline
    from repro_torch.launch.train import make_step_fn, token_batches
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    model = build_model(cfg, rcfg, device=device)
    params = model.init(0) if params is None else params
    step = make_step_fn(model, adamw.AdamWConfig(lr=lr, warmup_steps=10, total_steps=n_steps,
                                                 weight_decay=0.01))
    opt = adamw.init(params)
    data = token_batches(TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                  global_batch=batch, seed=rcfg.seed)), 0, device)
    keep = {k: v.detach().clone() for k, v in params[frozen].items()} if frozen else {}
    losses = []
    for _ in range(n_steps):
        params, opt, m = step(params, opt, next(data))
        with torch.no_grad():
            for k, v in keep.items():
                params[frozen][k].copy_(v)
        losses.append(m["loss"].item())
    return losses


def phase_lr_probe(n_steps: int = 20) -> None:
    """Not run by default.  Why the reference launcher's lr 3e-3 (set for
    its reduced config, d_model 128) raises rwkv6-1.6b's loss at full
    width: 20 steps of 8 x 512 tokens from seed-0 weights at lr 3e-3 and
    6e-4 over d_model 512, 1024 and 2048 (24 layers, 64-wide heads, d_ff
    3.5 d_model, vocab 65536, bf16), at d_model 2048 with the reduced
    config's vocab of 512, in fp32, and with the head or the embedding
    frozen at its init; then full width cut to 2 layers in
    fp32 on the card (kernels) and on the CPU (plain versions) from the
    same weights, 10 steps of 4 x 128 tokens at lr 3e-3."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import move_params
    from repro_torch.models.api import build_model
    full = get_config("rwkv6-1.6b")

    def show(what, losses):
        log(f"[lr-probe] {what}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (max "
            f"{max(losses):.4f}, last - first {losses[-1] - losses[0]:+.4f}); "
            f"{[round(x, 4) for x in losses]}")

    def width(d, **kw):
        return dataclasses.replace(full, d_model=d, n_heads=d // 64, n_kv_heads=d // 64,
                                   d_ff=7 * d // 2, **kw)
    runs = [(f"d_model {d}, bf16", width(d), RunConfig(), (3e-3, 6e-4), "")
            for d in (512, 1024, 2048)]
    runs += [("d_model 2048, vocab 512, bf16", width(2048, vocab_size=512), RunConfig(), (3e-3,),
              ""),
             ("d_model 2048, fp32", full, RunConfig(param_dtype="float32",
                                                    compute_dtype="float32"), (3e-3,), "")]
    runs += [(f"d_model 2048, {group} frozen, bf16", full, RunConfig(), (3e-3,), group)
             for group in ("head", "embed")]
    for what, cfg, rcfg, lrs, frozen in runs:
        for lr in lrs:
            show(f"{what}, lr {lr}", _train_losses(cfg, rcfg, lr, n_steps, 8, 512, "cuda",
                                                   frozen=frozen))
            torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=2)
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    p_cpu = build_model(cfg, rcfg, device="cpu").init(0)
    got = {dev: _train_losses(cfg, rcfg, 3e-3, 10, 4, 128, dev, move_params(p_cpu, dev))
           for dev in ("cuda", "cpu")}
    for dev, losses in got.items():
        show(f"d_model 2048, 2 layers, fp32, 4 x 128 tokens, lr 0.003, {dev}", losses)
    log(f"[lr-probe] 2 layers card vs CPU: worst relative loss difference "
        f"{max(abs(a - b) / abs(b) for a, b in zip(got['cuda'], got['cpu'])):.2e}")


# the C entry points the baseline phase calls: (source, entry, module of its argtypes)
BASELINE_LIBS = (("flash_attention", "flash_attention_fwd", "flash_attention"),
                 ("rmsnorm", "rmsnorm_fwd", "rmsnorm"),
                 ("decode_attention", "decode_attention_fwd", "decode_attention"),
                 ("paged_attention", "paged_decode_attention_fwd", "paged_attention"),
                 ("mamba2_ssd", "mamba2_ssd_fwd", "mamba2_ssd"),
                 ("rwkv6_scan", "rwkv6_fwd", "rwkv6_scan"))


def _library_fns(checkout: Path, out: Path) -> dict:
    """The C entry points of BASELINE_LIBS built from ``checkout``'s kernel
    sources with this checkout's flags into ``out``, each typed by the
    checkout's own wrapper module (its ``_ARGS``), and the checkout's own
    ``split_plan`` (how its decode wrappers cut the span) and flash module
    (whose ``split_plan``, where it has one, cuts its D = 64 calls)."""
    import ctypes
    import importlib.util
    from repro_torch.kernels import _build
    csrc = checkout / "src" / "repro_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o",
                                     str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, _, _ in BASELINE_LIBS}
    modules = {}
    for module in {m for _, _, m in BASELINE_LIBS}:
        spec = importlib.util.spec_from_file_location(f"_baseline_{module}_{out.name}",
                                                      csrc.parent / f"{module}.py")
        modules[module] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(modules[module])
    fns = {}
    for name, entry, module in BASELINE_LIBS:
        text, _ = procs[name].communicate()
        if procs[name].returncode != 0:
            raise RuntimeError(f"{csrc / name}.cu does not build:\n{text}")
        for line in text.splitlines():
            if "warning" in line.lower() or "(C7" in line or (name == "flash_attention" and
                                                               "spill" in line):
                log(f"[baseline] {checkout.name}/{name}: {line.strip()[:200]}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), entry)
        fn.argtypes = list(modules[module]._ARGS)
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["split_plan"] = modules["decode_attention"].split_plan
    fns["flash_module"] = modules["flash_attention"]
    return fns


# flash in the baseline phase: (B, T, Tk, H, G, D, causal), granite-8b's and
# zamba2-7b's shapes, then every D = 64 shape of FAMILY_FLASH
BASELINE_FLASH = ((2, 1024, 1024, 32, 8, 128, True), (8, 512, 512, 32, 32, 112, True),
                  (8, 128, 128, 32, 8, 128, True),
                  *((b, t, tk, h, g, d, causal)
                    for _, b, t, tk, h, g, d, causal, chunk in FAMILY_FLASH if d == 64))


def phase_baseline(baselines: list) -> None:
    """Opt-in (``--phases build,baseline --baseline DIR[,DIR...]``): the flash,
    RMSNorm, SSD, WKV6, dense decode and paged decode kernels of other
    checkouts (e.g. the parent commit unpacked with ``git archive``), built
    from their sources with this checkout's flags, timed in turns with this checkout's
    kernels on the same inputs and card: baseline, current, current,
    baseline.  Every library is called through its C entry point with
    preallocated outputs and scratch, so the times are the kernels' and their
    launches', without the Python wrappers; the decode kernels with each
    checkout's own split plan, and with the memset of their merge counters
    before every call where a kernel leaves them nonzero (as the wrapper of
    such a kernel does); flash at ``BASELINE_FLASH`` with each checkout's
    own argument types and, where it has one, its own D = 64 split plan."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba2_ssd as kssd
    from repro_torch.kernels import paged_attention as kpaged
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import rwkv6_scan as krwkv
    libs = {"current": _library_fns(ROOT, ROOT / "build" / "baseline" / "current")}
    for i, base in enumerate(baselines):
        libs[str(base)] = _library_fns(base.resolve(), ROOT / "build" / "baseline" / str(i))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def turns(what, calls):
        cur = calls.pop("current")
        for name, base in calls.items():
            a1, c1 = sync_time_ms(base, iters=FAST_ITERS), sync_time_ms(cur, iters=FAST_ITERS)
            c2, a2 = sync_time_ms(cur, iters=FAST_ITERS), sync_time_ms(base, iters=FAST_ITERS)
            log(f"[baseline] {what}: {name} {a1:.4f} / {a2:.4f} ms, current {c1:.4f} / "
                f"{c2:.4f} ms (turns: baseline, current, current, baseline); device "
                f"{device_ms(base):.4f} against {device_ms(cur):.4f} ms")

    def flash_extra(mod, b, t, tk, h, g, d, causal, keep):
        """The split arguments of a checkout's flash entry, where it takes
        them: its own ``split_plan`` at D = 64 bf16, with zeroed scratch for
        a split (kept alive in ``keep``)."""
        if not hasattr(mod, "split_plan"):
            return ()
        n_split = mod.split_plan(b, t, tk, h, g, causal, 0, sms) if d == 64 else 1
        if n_split == 1:
            return (1, sms, None, None)
        units = mod.d64_units(b, t, h, g)
        part = torch.empty((units * n_split * mod.PART_FLOATS,), device="cuda")
        counters = torch.zeros((units,), dtype=torch.int32, device="cuda")
        keep.append((part, counters))
        return (n_split, sms, part.data_ptr(), counters.data_ptr())

    keep = []                              # scratch the calls point into
    for b, t, tk, h, g, d, causal in BASELINE_FLASH:
        shape = f"B={b} T={t} Tk={tk} H={h} G={g} D={d} {'causal' if causal else 'full'} bf16"
        sets = [tuple(_rand((b, n, m, d), torch.bfloat16, gen)
                      for n, m in ((t, h), (tk, g), (tk, g)))
                for _ in range(n_sets(2 * (2 * b * t * h * d + 2 * b * tk * g * d)))]
        outs = [torch.empty_like(a[0]) for a in sets]
        ref = kfa.flash_attention_plain(*sets[0], causal=causal)
        calls = {}
        for name, fns in libs.items():
            extra = flash_extra(fns["flash_module"], b, t, tk, h, g, d, causal, keep)

            def call(a, o, fa=fns["flash_attention"], name=name, extra=extra):
                _build.check(fa(a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), o.data_ptr(),
                                b, t, tk, h, g, d, int(causal), 0, d ** -0.5, _build.DT_BF16,
                                *extra, stream), name)
            try:
                call(sets[0], outs[0])
                check_close(f"{name} flash {shape}", outs[0], ref, BF16_TOL, relative=True)
            except (RuntimeError, AssertionError) as e:
                if name == "current":
                    raise
                log(f"[baseline] {name} flash {shape} left out: {e}")
                continue
            calls[name] = [lambda a=a, o=o, call=call: call(a, o) for a, o in zip(sets, outs)]
        turns(f"flash {shape}", calls)
    for rows, d in RMS_SHAPES:
        sets = [(_rand((rows, d), torch.bfloat16, gen),
                 (1 + 0.1 * _rand((d,), torch.float32, gen)).to(torch.bfloat16))
                for _ in range(n_sets(rows * d * 2 * 2))]
        outs = [torch.empty_like(a[0]) for a in sets]
        calls = {}
        for name, fns in libs.items():
            def call(a, o, rms=fns["rmsnorm"], name=name):
                _build.check(rms(a[0].data_ptr(), a[1].data_ptr(), o.data_ptr(), rows, d, 1e-5,
                                 _build.DT_BF16, _build.DT_BF16, stream), name)
            call(sets[0], outs[0])
            check_close(f"{name} rmsnorm ({rows},{d})", outs[0], krms.rmsnorm_plain(*sets[0]),
                        BF16_TOL, relative=True)
            calls[name] = [lambda a=a, o=o, call=call: call(a, o) for a, o in zip(sets, outs)]
        turns(f"rmsnorm ({rows},{d}) bf16", calls)

    # the SSD and WKV6 forwards at the training shapes, bf16, with each
    # library's margin against the plain version (error / limit)
    sets = [ssd_inputs(gen, torch.bfloat16) for _ in range(n_sets(SSD_BYTES))]
    bsz, t, h, p, n = SSD_SHAPE
    outs = [(torch.empty((bsz, t, h, p), dtype=torch.bfloat16, device="cuda"),
             torch.empty((bsz, h, p, n), dtype=torch.float32, device="cuda")) for _ in sets]
    ry, rs = kssd.mamba2_ssd_chunked_plain(*sets[0])
    calls = {}
    for name, fns in libs.items():
        def call(a, o, fn=fns["mamba2_ssd"], name=name):
            x, dt, aa, bm, cm, dd = a
            _build.check(fn(x.data_ptr(), dt.data_ptr(), aa.data_ptr(), bm.data_ptr(),
                            cm.data_ptr(), dd.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
                            x.stride(0), x.stride(1), bm.stride(0), bm.stride(1), cm.stride(0),
                            cm.stride(1), bsz, t, h, p, n, _build.DT_BF16, stream), name)
        call(sets[0], outs[0])
        log(f"[baseline] {name} ssd margins: " + check_gates(f"{name} ssd", {
            "bf16 y": gate(outs[0][0], ry, BF16_TOL, True),
            "bf16 state": gate(outs[0][1], rs, SCAN_F32_TOL, False)}))
        calls[name] = [lambda a=a, o=o, call=call: call(a, o) for a, o in zip(sets, outs)]
    turns(f"ssd B={bsz} T={t} H={h} P={p} N={n} bf16", calls)
    del sets, outs, ry, rs
    sets = [rwkv6_inputs(gen, torch.bfloat16) for _ in range(n_sets(RWKV_BYTES))]
    outs = [torch.empty_like(a[0]) for a in sets]
    ref = krwkv.rwkv6_chunked_plain(*sets[0])
    bsz, t, h, dk = RWKV_SHAPE
    calls = {}
    for name, fns in libs.items():
        def call(a, o, fn=fns["rwkv6_scan"], name=name):
            _build.check(fn(*(x.data_ptr() for x in a), o.data_ptr(), bsz, t, h, dk,
                            _build.DT_BF16, stream), name)
        call(sets[0], outs[0])
        log(f"[baseline] {name} rwkv6 margin: " + check_gates(
            f"{name} rwkv6", {"bf16 out": gate(outs[0], ref, BF16_TOL, True)}))
        calls[name] = [lambda a=a, o=o, call=call: call(a, o) for a, o in zip(sets, outs)]
    turns(f"rwkv6 B={bsz} T={t} H={h} K={dk} bf16", calls)
    del sets, outs, ref

    # the decode kernels at phase 3's shapes: dense B=8 S=1024 (random lane
    # lengths) and paged B=16 bs=16 over 64 blocks (lanes of 16-1023 positions)
    h, g, d = 32, 8, 128
    scale = d ** -0.5
    b, s = 8, 1024
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[1] = 1, s
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    rng = np.random.default_rng(0)
    pb, bs, max_blocks = 16, 16, 64
    pos = rng.integers(16, 1024, size=pb)
    pos[0], pos[1] = 1023, 16
    tables, n_pool = paged_tables(rng, pos, bs, max_blocks, n_shared=4, shared_lanes=8)
    bt = torch.as_tensor(tables, device="cuda")
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    dense_sets = [(_rand((b, 1, h, d), torch.bfloat16, gen),
                   _rand((b, s, g, d), torch.bfloat16, gen),
                   _rand((b, s, g, d), torch.bfloat16, gen))
                  for _ in range(n_sets(2 * b * s * g * d * 2))]
    paged_sets = [(_rand((pb, 1, h, d), torch.bfloat16, gen),
                   _rand((n_pool, bs, g, d), torch.bfloat16, gen),
                   _rand((n_pool, bs, g, d), torch.bfloat16, gen))
                  for _ in range(n_sets(2 * n_pool * bs * g * d * 2))]
    cases = (
        (f"decode B={b} S={s} H={h} G={g} D={d} bf16 ({int(valid.sum())} live positions)",
         dense_sets, b, s, kdec.decode_attention_plain(*dense_sets[0], valid, scale),
         lambda fns, a, o, ns, sl, sc: fns["decode_attention"](
             a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), valid.data_ptr(), o.data_ptr(),
             *sc, b, s, h, g, d, sl, ns, scale, _build.DT_BF16, stream)),
        (f"paged B={pb} bs={bs} max_blocks={max_blocks} H={h} G={g} D={d} bf16 "
         f"({int((pos + 1).sum())} live positions)",
         paged_sets, pb, max_blocks * bs, kpaged.paged_decode_attention_plain(
             *paged_sets[0], bt, pos_t, scale),
         lambda fns, a, o, ns, sl, sc: fns["paged_attention"](
             a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), bt.data_ptr(), pos_t.data_ptr(),
             o.data_ptr(), *sc, pb, bs, max_blocks, h, g, d, ns, scale, _build.DT_BF16, stream)))
    keep = []                              # scratch the calls point into
    for what, sets, nb, span, ref, entry in cases:
        outs = [torch.empty_like(a[0]) for a in sets]
        calls = {}
        for name, fns in libs.items():
            split_len, n_split = fns["split_plan"](nb, g, span, sms)
            slots = nb * g * n_split
            part = torch.empty((slots * kdec.MAX_NREP * (2 + d),), dtype=torch.float32,
                               device="cuda")
            counters = torch.zeros((nb * g,), dtype=torch.int32, device="cuda")
            keep.append((part, counters))
            sc = (part.data_ptr(), part.data_ptr() + 4 * slots * kdec.MAX_NREP,
                  part.data_ptr() + 8 * slots * kdec.MAX_NREP, counters.data_ptr())

            def call(a, o, fns=fns, n_split=n_split, split_len=split_len, sc=sc, name=name):
                _build.check(entry(fns, a, o, n_split, split_len, sc), name)
            call(sets[0], outs[0])
            check_close(f"{name} {what}", outs[0], ref, BF16_TOL, relative=True)
            if counters.any():             # a kernel that needs its counters zeroed per call
                def call(a, o, call=call, counters=counters):
                    counters.zero_()
                    call(a, o)
            calls[name] = [lambda a=a, o=o, call=call: call(a, o) for a, o in zip(sets, outs)]
        turns(what, calls)


# ---------------------------------------------------------------------------

class Laps:
    """Logs each phase's wall time: ``lap(name)`` as a phase starts, ``lap()``
    after the last.  Between phases it collects cycles and returns the
    allocator's free blocks to the card, and logs the device memory still
    allocated before and after: a phase that leaves a model alive shows
    there, before a later phase that needs the whole card runs out."""

    def __init__(self):
        self.name, self.t0 = None, 0.0

    def __call__(self, name: str | None = None) -> None:
        now = time.perf_counter()
        if self.name is not None:
            held = torch.cuda.memory_allocated()
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[phase] {self.name}: {now - self.t0:.1f} s; device memory allocated after "
                f"it {held / 2**30:.3f} GiB, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
                f"once cycles are collected")
        self.name, self.t0 = name, now


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + OPT_IN}; {OPT_IN} run only "
                         f"when named")
    ap.add_argument("--baseline", default="",
                    help="comma-separated checkouts whose flash, RMSNorm, decode, paged, SSD "
                         "and WKV6 kernels the baseline phase times beside this one's")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    results: dict = {}
    t_start = time.perf_counter()
    lap = Laps()
    if "build" in phases:
        lap("build")
        phase_build()
    if "kernels" in phases:
        lap("kernels")
        phase_kernels(results)
    if "parity" in phases:
        lap("parity")
        phase_parity()
    if "parity_bf16" in phases:
        lap("parity_bf16")
        phase_parity_bf16()
    if "parity_train" in phases:
        lap("parity_train")
        phase_parity_train()
    full = full_width_model() if any(p in phases for p in GRANITE_PHASES) else None
    if "serve" in phases:
        lap("serve")
        phase_serve(results, *full)
    if "serve_paged" in phases:
        lap("serve_paged")
        phase_serve_paged(results, *full)
    if "serve_stages" in phases:
        lap("serve_stages")
        phase_serve_stages(results, *full)
        torch.cuda.empty_cache()
    if "agent" in phases:
        lap("agent")
        phase_agent(results, *full)
    if "serve_spec" in phases:
        lap("serve_spec")
        torch.cuda.empty_cache()
        phase_serve_spec(results, *full)
    if "serve_fleet" in phases:
        lap("serve_fleet")
        torch.cuda.empty_cache()
        phase_serve_fleet(results, *full)
    if "fed" in phases:
        lap("fed")
        torch.cuda.empty_cache()
        phase_fed(results, *full)
    del full
    torch.cuda.empty_cache()
    if "serve_rwkv" in phases:
        lap("serve_rwkv")
        phase_serve_recurrent(results, "rwkv6-1.6b", "rwkv")
        torch.cuda.empty_cache()
    if "serve_hybrid" in phases:
        lap("serve_hybrid")
        phase_serve_recurrent(results, "zamba2-7b", "hybrid")
        torch.cuda.empty_cache()
    if "serve_moe" in phases:
        lap("serve_moe")
        phase_serve_moe(results)
        torch.cuda.empty_cache()
    if "serve_encdec" in phases:
        lap("serve_encdec")
        phase_serve_family(results, "whisper-small", "encdec", max_batch=8, max_len=448,
                           lengths=np.linspace(4, 200, 16).astype(int))
        torch.cuda.empty_cache()
    if "serve_vlm" in phases:
        lap("serve_vlm")
        phase_serve_family(results, "internvl2-1b", "vlm", max_batch=8, max_len=1536,
                           lengths=np.linspace(16, 400, 16).astype(int))
        torch.cuda.empty_cache()
    if "serve_dense_configs" in phases:
        lap("serve_dense_configs")
        phase_serve_dense_configs(results)
        torch.cuda.empty_cache()
    if "train" in phases:
        lap("train")
        phase_train(results)
        torch.cuda.empty_cache()
    if "train_hybrid" in phases:
        lap("train_hybrid")
        phase_train_hybrid(results)
        torch.cuda.empty_cache()
    if "resnet" in phases:
        lap("resnet")
        phase_resnet()
        torch.cuda.empty_cache()
    if "train_pp" in phases:
        lap("train_pp")
        phase_train_pp(results)
    if "parity_gspmd" in phases:
        lap("parity_gspmd")
        phase_parity_gspmd()
    if "train_gspmd" in phases:
        lap("train_gspmd")
        phase_train_gspmd(results)
    if "dryrun" in phases:
        lap("dryrun")
        phase_dryrun()
    if "lr_probe" in phases:
        lap("lr_probe")
        phase_lr_probe()
    if "baseline" in phases:
        lap("baseline")
        if not args.baseline:
            raise SystemExit("the baseline phase needs --baseline DIR[,DIR...]")
        phase_baseline([Path(p) for p in args.baseline.split(",")])
    lap()
    kernels = [dict(r, launches=r.get("launches")) for r in results.values()]
    if "kernels" in phases and len(kernels) != len(ops.launch_counts()):
        raise AssertionError(f"kernels line lists {[k['name'] for k in kernels]}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
