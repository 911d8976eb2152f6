"""The unsplit training step: ``make_step_fn`` of the program's training
launcher over its model and AdamW, on token batches drawn from the seed,
one new batch a step.

Set-up builds the one step object and drives it through the first
``checked_steps`` steps, which the reference follows: their losses, the
gradient of step 1 as the optimizer received it (its first moment over
1 - b1) and the change of the parameters after the last of them are kept,
then the same object runs the window."""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch

from harness.yardstick import sync

from reference.common import draw, tree


def walk(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from walk(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from walk(v, path + (i,))
    else:
        yield path, node


def norms(flat: Dict) -> Dict:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) for k, v in flat.items()}


class Run:
    def __init__(self, cell, seed: int, device, tracer, seconds: float, hooks: Dict = None):
        from repro_torch.configs.base import ModelConfig, RunConfig
        from repro_torch.launch.train import make_step_fn
        from repro_torch.models.api import build_model
        from repro_torch.optim import adamw
        self.cell, self.seed, self.tracer, self.device = cell, seed, tracer, device
        cfg, mix = cell.config, cell.traffic
        self.m = cfg["model"]
        self.specs = cell.reference().param_specs(self.m)
        flat = draw(self.specs, seed, device)
        start = {k: v.clone() for k, v in flat.items()}
        self.params = tree(flat)
        model = build_model(ModelConfig(**self.m), RunConfig(
            param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"], remat=cfg["remat"]),
            device=device)
        self.step_fn = make_step_fn(model, adamw.AdamWConfig(**cfg["optimizer"]))
        self.opt = adamw.init(self.params)
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.shape = (mix["batch"], mix["seq"])
        feed = (hooks or {}).get("batch", lambda t: t)
        self.batches: List[torch.Tensor] = []
        losses = []
        for i in range(mix["checked_steps"]):
            tokens = self.next_tokens()
            self.batches.append(tokens)
            self.params, self.opt, stats = self.step_fn(self.params, self.opt,
                                                        {"tokens": feed(tokens)})
            losses.append(float(stats["loss"]))
            if i == 0:
                b1 = cfg["optimizer"]["b1"]
                grads = norms({k: m / (1 - b1) for k, m in walk(self.opt["m"])})
        change = norms({k: p.float() - start[k].float() for k, p in walk(self.params)})
        del start
        self.program = {"losses": losses, "grad_norms": grads, "change_norms": change}
        sync()

    def next_tokens(self) -> torch.Tensor:
        return torch.randint(0, self.m["vocab_size"], self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def window(self, seconds: float) -> Dict:
        tracer, tr = self.tracer, self.cell.traffic["trace"]
        losses, n, traced = [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer.on and not tracer.done and n == tr["from_step"]:
                tracer.start()
            with tracer.span("bench.train.step"):
                self.params, self.opt, stats = self.step_fn(self.params, self.opt,
                                                            {"tokens": self.next_tokens()})
            losses.append(stats["loss"])
            n += 1
            traced += tracer.active
            if tracer.active and n == tr["from_step"] + tr["steps"]:
                tracer.stop()
        sync()
        t1 = time.perf_counter()
        if tracer.active:
            tracer.stop()
        losses = torch.stack(losses).float().cpu().tolist()
        finite = all(x == x and abs(x) != float("inf") for x in losses)
        self.params = self.opt = self.step_fn = None
        torch.cuda.empty_cache()
        b, t = self.shape
        return {"window_s": t1 - t0, "attempted": n, "failed": 0 if finite else n,
                "steps": n, "tokens": n * b * t, "losses": losses,
                "untraced": {"seconds": tracer.untraced_s(t0, t1),
                             "steps": {"train.step": n - traced},
                             "tokens": (n - traced) * b * t},
                "params_nonembed": sum(math.prod(s[1]) for s in self.specs
                                       if s[0][0] not in ("embed", "head"))}

    def check(self, fp8: bool = False) -> Dict[str, float]:
        """The program's first steps against the reference's from the same
        weights and batches (``fp8``: the float8 control in the program's
        place instead)."""
        ref = self.cell.reference()
        opt = self.cell.config["optimizer"]
        flat = draw(self.specs, self.seed, self.device)
        start = {k: v.clone() for k, v in flat.items()}
        got = ref.train(self.m, opt, flat, self.batches)
        got["change_norms"] = norms({k: flat[k].float() - start[k].float() for k in flat})
        del flat, start
        torch.cuda.empty_cache()
        out = compare(self.program, got)
        if fp8:
            flat = draw(self.specs, self.seed, self.device)
            start = {k: v.clone() for k, v in flat.items()}
            low = ref.train(self.m, opt, flat, self.batches, fp8=True)
            low["change_norms"] = norms({k: flat[k].float() - start[k].float() for k in flat})
            del flat, start
            out.update({"control_" + k: v for k, v in compare(low, got).items()})
        return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss as a share of the reference's; then, by the worst
    leaf, the gap between the program's norm and the reference's of the
    first step's gradient and of the parameters' change, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(prog["grad_norms"][k] - g) / max(g, g_med) for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change = max(abs(prog["change_norms"][k] - c_ref[k]) / max(c_ref[k], c_med, 1e-30)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "leaves_left_out": float(len(g_ref) - len(moved))}
