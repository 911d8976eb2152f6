"""Pieces the plain references share: parameter specs, weight drawing,
float8 rounding for the control, RMSNorm and the AdamW of the configuration.

Plain PyTorch, fp32 arithmetic with TF32 off; imports nothing of the
program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

Path = Tuple                                 # ("blocks", 3, "attn", "wq")
Spec = Tuple[Path, Tuple[int, ...], str, str, float]   # path, shape, dtype, init, value

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """fp32 matrix products in fp32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """Rows the program's embedding table holds (its tree's layout)."""
    return -(-vocab // multiple) * multiple


def draw(specs: List[Spec], seed: int, device) -> Dict[Path, torch.Tensor]:
    """Every leaf of ``specs`` from ``seed`` on ``device``: normal leaves are
    views of one buffer per dtype, filled by a few large ``normal_`` calls of
    a generator on the device and scaled leaf by leaf; constant leaves are
    filled.  The same seed gives the same tensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[Path, torch.Tensor] = {}
    for dt_name in sorted({s[2] for s in specs}):
        dt = DTYPES[dt_name]
        normal = [s for s in specs if s[2] == dt_name and s[3] == "normal"]
        total = sum(math.prod(s[1]) for s in normal)
        buf = torch.empty(total, dtype=dt, device=device)
        step = 1 << 30
        for lo in range(0, total, step):
            buf[lo:lo + step].normal_(generator=gen)
        off = 0
        for path, shape, _, _, scale in normal:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            leaf.mul_(scale)
            out[path] = leaf
            off += n
    for path, shape, dt_name, init, value in specs:
        if init == "const":
            out[path] = torch.full(shape, value, dtype=DTYPES[dt_name], device=device)
    return out


def tree(flat: Dict[Path, torch.Tensor]) -> dict:
    """Nested dicts and lists (an int key makes a list) from paths."""
    root: dict = {}
    for path in sorted(flat, key=lambda p: [str(x).zfill(6) for x in p]):
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if key not in node:
                node[key] = {}
            node = node[key]
        node[path[-1]] = flat[path]
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim`` (the control's lower precision), back in fp32; the gradient
    passes the rounding unchanged (straight through)."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = E4M3_MAX / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return t + (q - t.detach())


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x @ w in fp32; with ``fp8`` both operands rounded to e4m3 first (x per
    row, w per output column)."""
    if fp8:
        return fp8_round(x, -1) @ fp8_round(w, 0)
    return x @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps`` then cosine decay to 0 at
    ``total_steps`` (the configuration's schedule)."""
    if opt["schedule"] != "cosine":
        raise ValueError(f"the reference follows a cosine schedule, not {opt['schedule']!r}")
    warm = min(1.0, (step + 1) / max(opt["warmup_steps"], 1))
    frac = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["total_steps"] - opt["warmup_steps"])))
    return opt["lr"] * warm * 0.5 * (1 + math.cos(math.pi * frac))


class AdamW:
    """AdamW as the configuration states it: global-norm clipping, bias
    correction, ``eps`` added to the square root, decoupled weight decay on
    leaves of two or more dimensions, fp32 moments, and the parameters
    stored in their own dtype (bf16: updated in fp32, then rounded)."""

    def __init__(self, opt: Dict, params: Dict[Path, torch.Tensor]):
        self.opt, self.step = opt, 0
        self.m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()}
        self.v = {k: torch.zeros_like(m) for k, m in self.m.items()}

    @torch.no_grad()
    def update(self, params: Dict[Path, torch.Tensor],
               grads: Dict[Path, torch.Tensor]) -> Dict[Path, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        o = self.opt
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
        scale = min(1.0, o["clip_norm"] / (gnorm + 1e-9))
        lr, t = lr_at(o, self.step), self.step + 1
        bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        clipped = {}
        for k, p in params.items():
            g = grads[k].float() * scale
            clipped[k] = g
            m, v = self.m[k], self.v[k]
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"])
            p32 = p.float()
            if p.ndim >= 2:
                delta = delta + o["weight_decay"] * p32
            p.copy_(p32 - lr * delta)
        self.step += 1
        return clipped
