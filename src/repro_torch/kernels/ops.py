"""Public entry points of the port's kernels.

Routing: a tensor on the CPU goes to the kernel's plain PyTorch version; a
tensor on a CUDA device launches the hand-written kernel, which raises on
what it does not take.  There is no fallback between the two.

Gradients: on CUDA tensors that need one, ``flash_attention``, ``rmsnorm``,
``rwkv6_scan`` and ``mamba2_ssd`` go through ``torch.autograd.Function``s
whose forward is the kernel and whose backward is autograd through the
plain version,
recomputed from the saved inputs (the reference's oracle-AD backward,
``repro/kernels/ops.py``); without grad mode, or when no input requires
grad, they call the kernel directly, so serving pays no autograd cost.
Each backward runs inside a span (:func:`repro_torch.runtime.spans.span`),
``flash_attention_backward``, ``rmsnorm_backward``, ``rwkv6_backward`` and
``mamba2_ssd_backward``, so a profile reads its device time within a step;
with no profiler recording, a span enters no ``record_function`` and costs
a check of the profiler's state.
The decode and paged kernels serve only: they raise if an input requires
grad while grad mode is on, so no gradient is dropped silently.  On CPU
tensors the plain versions are differentiable as they are.

Each kernel module keeps a plain-integer count of its launches
(``<module>.launches``); :func:`launch_counts` reads them all, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import rwkv6_scan as _rwkv
from repro_torch.runtime.spans import span

_COUNTED = {"flash_attention": _fa, "decode_attention": _dec,
            "paged_decode_attention": _paged, "rmsnorm": _rms, "rwkv6_scan": _rwkv,
            "mamba2_ssd": _ssd}


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain_vjp(plain: Callable[..., torch.Tensor], saved: Sequence[torch.Tensor],
               needs: Sequence[bool], grad_out: torch.Tensor):
    """Gradients of ``plain(*saved)`` for the inputs that need one (None for
    the rest), by autograd through a recomputation."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*xs)
        wanted = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return tuple(next(got) if n else None for n in needs)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, scale=scale, chunk=chunk)
        return _fa.flash_attention_cuda(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        plain = lambda q, k, v: _fa.flash_attention_plain(q, k, v, **ctx.opts)
        with span("flash_attention_backward"):
            return _plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:3], g) \
                + (None, None, None)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms.rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        plain = lambda x, s: _rms.rmsnorm_plain(x, s, ctx.eps)
        with span("rmsnorm_backward"):
            return _plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:2], g) + (None,)


class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        ctx.save_for_backward(r, k, v, log_w, u)
        return _rwkv.rwkv6_cuda(r, k, v, log_w, u)

    @staticmethod
    def backward(ctx, g):
        with span("rwkv6_backward"):
            return _plain_vjp(_rwkv.rwkv6_chunked_plain, ctx.saved_tensors,
                              ctx.needs_input_grad, g)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        ctx.save_for_backward(x, dt, A, B, C, D)
        y, state = _ssd.mamba2_ssd_cuda(x, dt, A, B, C, D)
        # the reference drops the final state's cotangent (its _ssd_b): the
        # state is consumed only by decode, which has no training path
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, gy, _gstate):
        with span("mamba2_ssd_backward"):
            return _plain_vjp(lambda *a: _ssd.mamba2_ssd_chunked_plain(*a)[0],
                              ctx.saved_tensors, ctx.needs_input_grad, gy)


def _serving_only(name: str, *tensors: torch.Tensor) -> None:
    if _needs_grad(*tensors):
        raise RuntimeError(f"{name} serves only and has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not require grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    chunk: int = 0) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,Tk,G,D) -> (B,T,H,D)."""
    if _on_cpu(q):
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale, chunk=chunk)
    if not _needs_grad(q, k, v):
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale, chunk=chunk)
    return _Flash.apply(q, k, v, causal, scale, chunk)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,1,H,D), ck/cv (B,S,G,D), valid (B,S) bool -> (B,1,H,D)."""
    if _on_cpu(q):
        return _dec.decode_attention_plain(q, ck, cv, valid, scale)
    _serving_only("decode_attention", q, ck, cv)
    return _dec.decode_attention_cuda(q, ck, cv, valid, scale)


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """q (B,1,H,D), kp/vp (NB,bs,G,D) block pool, block_tables (B,max_blocks)
    int32, pos (B,) int32 last attended position -> (B,1,H,D)."""
    if _on_cpu(q):
        return _paged.paged_decode_attention_plain(q, kp, vp, block_tables, pos, scale)
    _serving_only("paged_decode_attention", q, kp, vp)
    return _paged.paged_decode_attention_cuda(q, kp, vp, block_tables, pos, scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _on_cpu(x):
        return _rms.rmsnorm_plain(x, scale, eps)
    if not _needs_grad(x, scale):
        return _rms.rmsnorm_cuda(x, scale, eps)
    return _RMSNorm.apply(x, scale, eps)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Model-facing signature: w (B,T,H,K) is the DECAY in (0, 1)
    (``models/rwkv.py``); the kernel takes the fp32 log-decay, formed in the
    reference's order, ``log(max(w, 1e-38))``.  Returns out (B,T,H,K) (the
    reference also returns a final-state marker, always None)."""
    log_w = torch.log(torch.clamp(w.float(), min=1e-38))
    if _on_cpu(r):
        return _rwkv.rwkv6_chunked_plain(r, k, v, log_w, u)
    if not _needs_grad(r, k, v, log_w, u):
        return _rwkv.rwkv6_cuda(r, k, v, log_w, u)
    return _RWKV6.apply(r, k, v, log_w, u)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); dt (B,T,H) fp32; A (H,) <= 0; B/C (B,T,N) shared by the
    heads; D (H,).  Returns (y (B,T,H,P), final state (B,H,P,N) fp32); the
    state carries no gradient on either device, as in the reference."""
    if _on_cpu(x):
        y, state = _ssd.mamba2_ssd_chunked_plain(x, dt, A, B, C, D)
        return y, state.detach()
    if not _needs_grad(x, dt, A, B, C, D):
        return _ssd.mamba2_ssd_cuda(x, dt, A, B, C, D)
    return _SSD.apply(x, dt, A, B, C, D)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
