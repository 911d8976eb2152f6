"""RMSNorm: the Hopper kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm_fwd``; it is bound by bytes (one read of
x, one write of y), so it keeps each row on one SM and touches device memory
once each way.  :func:`rmsnorm_plain` ports ``repro/kernels/ref.py::rmsnorm_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches made by rmsnorm_cuda in this process
launches = 0

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., D) bf16/f32 on a CUDA device; scale (D,) bf16/f32."""
    global launches
    d = x.shape[-1]
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm_cuda needs x and scale on one CUDA device, got "
                         f"{x.device} and {scale.device}")
    if x.dtype not in _DT or scale.dtype not in _DT:
        raise TypeError(f"rmsnorm_cuda takes float32/bfloat16, got {x.dtype}, {scale.dtype}")
    if tuple(scale.shape) != (d,) or d == 0:
        raise ValueError(f"scale shape {tuple(scale.shape)} does not match x's last dim {d}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    fn = _build.function("rmsnorm", "rmsnorm_fwd", _ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, eps,
                    _DT[x.dtype], _DT[scale.dtype], stream), "rmsnorm_fwd")
    launches += 1
    return out
