"""Offline batch serving: a queue of unique prompts, larger than the
window can finish, all submitted when the window opens; the engine steps
until the window's time is up.  Every token a step emits in the window
counts.  In a traced run the requests' progress is taken when the traced
slice starts and when it stops, so that the readers can leave the slice
out of the work and the time."""

from __future__ import annotations

import collections
import time
from typing import Dict

from harness import generate
from harness.serving import Served


class Run:
    def __init__(self, cell, seed: int, device, tracer, seconds: float):
        self.cell, self.seed, self.tracer = cell, seed, tracer
        self.served = Served(cell, seed, device, tracer)
        mix = cell.traffic
        self.work = generate.offline(mix, seed, self.served.m["vocab_size"])
        lens = [len(p) for p in self.work.prompts]
        warm = self.served.bucket_prompts(
            self.served.buckets_for(min(lens), max(lens)), generate.rng_for(seed, "warm"))
        self.served.warm(warm)
        self.requests = []

    def window(self, seconds: float) -> Dict:
        eng, tracer, mix = self.served.engine, self.tracer, self.cell.traffic
        t_from = mix["trace"]["from"] * seconds
        t_len = min(mix["trace"]["seconds"], mix["trace"]["max_share"] * seconds)
        t0 = time.perf_counter()
        rejected = sum(eng.submit(p, m) is None
                       for p, m in zip(self.work.prompts, self.work.max_new))
        at = {"start": [], "stop": []}
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if tracer.on and not tracer.active and not tracer.done and now >= t_from:
                at["start"] = self.progress()
                tracer.start()
            elif tracer.active and time.perf_counter() - tracer.t_begin >= t_len:
                tracer.stop()
                at["stop"] = self.progress()
            self.served.step()
        t1 = time.perf_counter()
        if tracer.active:
            tracer.stop()
            at["stop"] = self.progress()
        requests = self.progress()
        self.finished = list(eng.finished)
        snap = self.served.snapshot()
        self.served.release()
        steps = self.served.steps
        return {
            "window_s": t1 - t0,
            "attempted": len(self.work.prompts),
            "failed": int(rejected),
            "tokens": sum(g for _, g in requests),
            "requests": requests,
            "steps": steps,
            "prefills": self.served.prefills,
            "snapshot": snap,
            "untraced": {"seconds": tracer.untraced_s(t0, t1),
                         "steps": dict(collections.Counter(s.label for s in steps
                                                           if not s.traced)),
                         "at_start": at["start"], "at_stop": at["stop"]},
        }

    def progress(self):
        """(prompt tokens, tokens served) of every request admitted so far."""
        eng = self.served.engine
        return [(len(r.prompt), len(r.out_tokens))
                for r in list(eng.finished) + [r for r in eng.slots if r is not None]]

    def check(self, fp8: bool = False) -> Dict[str, float]:
        return self.served.check(self.finished, fp8)
