"""The port's kernel modules against the JAX kernels and oracles.

On the CPU each wrapper takes its kernel's plain PyTorch version; those are
held to the Pallas kernels (run in interpret mode, as tests/test_kernels.py
runs them) and to the reference oracles on the same numpy inputs.  The CUDA
kernels themselves are compared with the plain versions by
``tests/test_torch_cuda.py`` (skipped without a card) and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.decode_attention import decode_attention_fwd
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as krms

F32_TOL = 3e-5      # fp32: same algorithm, sums in another order
BF16_TOL = 2e-2     # bf16: both sides round fp32 results to 8 mantissa bits


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _normal(seed, shape, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def _err(port: torch.Tensor, ref) -> float:
    return float(np.abs(port.float().numpy() - np.asarray(ref, np.float32)).max())


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (130, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax(shape, dtype):
    x = _normal(0, shape, dtype)
    s = (1.0 + 0.1 * _normal(1, (shape[-1],))).astype(x.dtype)
    out = krms.rmsnorm_plain(tensor_from_numpy(x), tensor_from_numpy(s))
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    kern = rmsnorm_fwd(jnp.asarray(x), jnp.asarray(s), block_rows=32, interpret=True)
    assert _err(out, kern.astype(jnp.float32)) < _tol(dtype)
    assert _err(out, kref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s)).astype(jnp.float32)) \
        < _tol(dtype)


@pytest.mark.parametrize("b,t,h,g,d,causal,chunk", [
    (2, 256, 4, 2, 32, True, 0),
    (1, 200, 4, 4, 64, True, 0),        # MHA + ragged T
    (2, 256, 8, 2, 64, True, 64),       # chunked-local
    (1, 128, 2, 1, 32, False, 0),       # non-causal
    (1, 96, 6, 3, 128, True, 0),        # head_dim 128, ragged against every block
])
def test_flash_plain_matches_jax(b, t, h, g, d, causal, chunk):
    q, k, v = (_normal(i, (b, t, n, d)) for i, n in enumerate((h, g, g)))
    # small blocks so the plain version runs several ragged tiles
    out = kfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal, chunk=chunk,
                                    block_q=64, block_k=80)
    kern = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               chunk=chunk, block_q=64, block_k=128, interpret=True)
    oracle = kref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, chunk=chunk)
    assert _err(out, kern) < F32_TOL
    assert _err(out, oracle) < F32_TOL


def test_flash_plain_bf16_matches_oracle():
    q, k, v = (_normal(i, (1, 160, n, 64), "bfloat16") for i, n in enumerate((4, 2, 2)))
    out = kfa.flash_attention_plain(*(tensor_from_numpy(a) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    oracle = kref.flash_attention_ref(*(jnp.asarray(a).astype(jnp.float32) for a in (q, k, v)))
    assert _err(out, oracle) < BF16_TOL


@pytest.mark.parametrize("b,h,g,d,span", [(2, 4, 2, 32, 96), (1, 8, 8, 64, 64),
                                          (3, 32, 8, 128, 70)])
def test_decode_plain_matches_jax(b, h, g, d, span):
    q = _normal(0, (b, 1, h, d))
    ck, cv = _normal(1, (b, span, g, d)), _normal(2, (b, span, g, d))
    pos = np.random.default_rng(3).integers(1, span, size=b)
    valid = np.arange(span)[None] <= pos[:, None]                    # ragged per lane
    out = kdec.decode_attention_plain(*(torch.from_numpy(a) for a in (q, ck, cv, valid)),
                                      d ** -0.5)
    kern = decode_attention_fwd(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(valid), scale=d ** -0.5, block_s=32,
                                interpret=True)
    oracle = kref.decode_attention_ref(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(valid), d ** -0.5)
    assert _err(out, kern) < F32_TOL
    assert _err(out, oracle) < F32_TOL


@pytest.mark.parametrize("b,g,s,sms", [(8, 8, 1024, 132), (1, 1, 64, 132), (2, 8, 4096, 132),
                                       (8, 8, 1000, 132), (64, 8, 128, 132), (1, 2, 65, 4)])
def test_decode_split_plan_covers_span(b, g, s, sms):
    split_len, n_split = kdec.split_plan(b, g, s, sms)
    assert split_len % kdec.TILE == 0
    assert n_split * split_len >= s > (n_split - 1) * split_len     # no empty slice
    assert n_split == 1 or b * g * n_split <= 2 * sms + b * g        # about two CTAs per SM


def test_ops_route_cpu_tensors_to_plain_versions():
    """A CPU tensor takes the plain version and launches nothing."""
    ops.reset_launch_counts()
    x = torch.from_numpy(_normal(0, (3, 64)))
    s = torch.ones(64)
    assert torch.equal(ops.rmsnorm(x, s), krms.rmsnorm_plain(x, s))
    q = torch.from_numpy(_normal(1, (1, 40, 4, 32)))
    k = torch.from_numpy(_normal(2, (1, 40, 2, 32)))
    assert torch.equal(ops.flash_attention(q, k, k, causal=True, scale=0.2),
                       kfa.flash_attention_plain(q, k, k, causal=True, scale=0.2))
    valid = torch.arange(40)[None] < 7
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, valid, 0.2),
                       kdec.decode_attention_plain(q[:, :1], k, k, valid, 0.2))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on a CUDA tensor or raise; they never
    compute on another device."""
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        krms.rmsnorm_cuda(x, torch.ones(64))
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        kdec.decode_attention_cuda(q[:, :1], q[:, :, :2], q[:, :, :2],
                                   torch.ones(1, 8, dtype=torch.bool), 0.1)
