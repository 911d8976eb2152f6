"""What the serving drivers share: the engine under test built on the
seed's weights, the warm-up of the cell's own prefill buckets, a step with
its host record, and the served check.

The program is ``repro_torch``'s ``ServeEngine``: ``submit`` and ``step``
are the calls the window drives.  The benchmark wraps one thing of it, the
model's batched prefill, in a span of its own that records each dispatch's
shape (batch, bucket) for the flash roofline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness.yardstick import sync

from harness.generate import rng_for
from reference.common import draw, tree


@dataclasses.dataclass
class StepRecord:
    start: float
    end: float
    label: str                    # the span it ran in: "step.admit" or "step.decode"
    admitted: bool                # a prefill dispatch happened
    live: int                     # positions the decode attended, summed over lanes
    lanes: int                    # lanes running before the step (each decodes a token)
    traced: bool


class Served:
    def __init__(self, cell, seed: int, device, tracer):
        from repro_torch.configs.base import ModelConfig, RunConfig
        from repro_torch.models.api import build_model
        from repro_torch.serving.engine import EngineConfig, ServeEngine
        self.cell, self.seed, self.tracer = cell, seed, tracer
        self.m = cell.config["model"]
        ref = cell.reference()
        self.params = tree(draw(ref.param_specs(self.m), seed, device))
        dt = cell.config["dtype"]
        model = build_model(ModelConfig(**self.m), RunConfig(param_dtype=dt, compute_dtype=dt,
                                                             remat=False), device=device)
        self.prefills: List[tuple] = []            # (batch, bucket) of traced dispatches
        ds = model.decode_state
        inner = ds.batched_prefill

        def prefill(p, batch, lengths, max_len):
            if not self.tracer.active:
                return inner(p, batch, lengths, max_len)
            self.prefills.append(tuple(batch["tokens"].shape))
            with self.tracer.span("bench.prefill"):
                return inner(p, batch, lengths, max_len)

        model = dataclasses.replace(model, decode_state=dataclasses.replace(
            ds, batched_prefill=prefill))
        e = cell.traffic["engine"]
        cfg = EngineConfig(kv_blocks=e.get("kv_blocks"), kv_block_size=e.get("kv_block_size", 16),
                           prefix_cache=e.get("prefix_cache", False), backend=e.get("backend"))
        self.engine = ServeEngine(model, self.params, e["max_batch"], e["max_len"], config=cfg)
        self.steps: List[StepRecord] = []

    # ------------------------------------------------------------------
    def warm(self, prompts: List[np.ndarray]) -> None:
        """Serve ``prompts`` (two tokens each) to the end, then zero the
        engine's counters: every bucket and batch the cell will dispatch
        has run once."""
        for p in prompts:
            self.engine.submit(p, 2)
        self.engine.run_until_drained()
        sync()
        self.engine.reset_stats()

    def bucket_prompts(self, lengths: List[int], rng, prefix: Optional[np.ndarray] = None
                       ) -> List[np.ndarray]:
        """A full prefill batch of prompts at each length (after ``prefix``)."""
        vocab, n = self.m["vocab_size"], self.engine.max_prefill_batch
        out = []
        for length in lengths:
            for _ in range(n):
                head = [] if prefix is None else [prefix]
                tail = rng.integers(0, vocab, size=length - sum(len(h) for h in head))
                out.append(np.concatenate(head + [tail.astype(np.int32)]).astype(np.int32))
        return out

    def buckets_for(self, lo: int, hi: int) -> List[int]:
        """The engine's prefill buckets that prompts of lo..hi tokens use."""
        bs = self.engine.buckets
        used = {next((b for b in bs if b >= n), self.engine.max_len) for n in (lo, hi)}
        return [b for b in bs if min(used) <= b <= max(used)]

    # ------------------------------------------------------------------
    def step(self) -> StepRecord:
        eng, traced = self.engine, self.tracer.active
        admit = eng.scheduler.depth > 0 and eng.active() < eng.max_batch
        live = lanes = 0
        if traced:
            for r in eng.slots:
                if r is not None:
                    live += len(r.prompt) + len(r.out_tokens)
                    lanes += 1
        before = eng.metrics.prefill_dispatches
        label = "step.admit" if admit else "step.decode"
        t0 = time.perf_counter()
        with self.tracer.span("bench." + label):
            eng.step()
        rec = StepRecord(t0, time.perf_counter(), label,
                         eng.metrics.prefill_dispatches != before, live, lanes, traced)
        self.steps.append(rec)
        return rec

    def snapshot(self) -> Dict:
        return self.engine.metrics_snapshot().as_dict()

    def release(self) -> None:
        """Free the engine (its lanes or pool); the weights stay, they are
        the benchmark's inputs and the reference reads them."""
        self.engine = None
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self, finished: list, fp8: bool = False) -> Dict[str, float]:
        """The widest gap by which a served token's logit lies below the
        reference's best, over a sample (from the seed) of finished
        requests with the longest among them, at least ``check.requests``
        requests and ``check.served_tokens`` served tokens.  With ``fp8``
        also ``control_logit_gap``: the gap of the token that the float8
        control puts first at every position."""
        pool = [r for r in finished if r.out_tokens]
        if not pool:
            return {"served_requests": 0.0}
        want = self.cell.traffic["check"]
        longest = max(pool, key=lambda r: (len(r.prompt) + len(r.out_tokens), -r.rid))
        sample, n = [longest], len(longest.out_tokens)
        for i in rng_for(self.seed, "check").permutation(len(pool)):
            if n >= want["served_tokens"] and len(sample) >= want["requests"]:
                break
            if pool[i] is not longest:
                sample.append(pool[i])
                n += len(pool[i].out_tokens)
        dev = self.params["final_ln"]["scale"].device
        seqs, pos, toks = [], [], []
        for r in sample:
            p, o = np.asarray(r.prompt), np.asarray(r.out_tokens)
            seqs.append(torch.as_tensor(np.concatenate([p, o[:-1]]), device=dev))
            pos.append(torch.arange(len(p) - 1, len(p) + len(o) - 1, device=dev))
            toks.append(torch.as_tensor(o, device=dev).long())
        ref = self.cell.reference()
        logits = ref.logits_at(self.m, self.params, seqs, pos)
        gap = lambda lg, t: float((lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).max())
        out = {"logit_gap": max(gap(lg, t) for lg, t in zip(logits, toks)),
               "served_tokens": float(n), "served_requests": float(len(sample))}
        if fp8:
            low = ref.logits_at(self.m, self.params, seqs, pos, fp8=True)
            out["control_logit_gap"] = max(gap(lg, lo.argmax(-1))
                                           for lg, lo in zip(logits, low))
        return out
