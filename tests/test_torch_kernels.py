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
from repro.kernels.paged_attention import paged_decode_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro.models.attention import _repeat_kv, sdpa
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import mamba2_ssd as kssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import rwkv6_scan as krwkv

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
                                          (3, 32, 8, 128, 70),
                                          (2, 32, 32, 112, 70),    # zamba2's shared block
                                          (2, 16, 4, 112, 50)])    # head_dim 112, GQA
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


@pytest.mark.parametrize("span,block_s", [(64, 32), (96, 32), (40, 40)])
def test_decode_plain_empty_lane_is_mean_of_v(span, block_s):
    """A lane whose valid row is all False: the Pallas kernel's finite mask
    makes its softmax uniform, so it returns the mean of V over the span;
    the plain version (and so the CUDA kernel it holds) must agree."""
    b, h, g, d = 3, 8, 2, 32
    q = _normal(0, (b, 1, h, d))
    ck, cv = _normal(1, (b, span, g, d)), _normal(2, (b, span, g, d))
    valid = np.arange(span)[None] <= np.array([[5], [-1], [span - 1]])
    assert not valid[1].any()
    out = kdec.decode_attention_plain(*(torch.from_numpy(a) for a in (q, ck, cv, valid)),
                                      d ** -0.5)
    kern = decode_attention_fwd(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(valid), scale=d ** -0.5, block_s=block_s,
                                interpret=True)
    assert _err(out, kern) < F32_TOL
    mean_v = np.repeat(cv[1].mean(0), h // g, axis=0)                # (H, D), GQA heads
    assert _err(out[1, 0], mean_v) < F32_TOL
    assert _err(out[1, 0], np.asarray(kern)[1, 0]) < F32_TOL


def _paged_case(seed, b, h, g, d, bs, max_blocks, pos, dtype="float32"):
    """Inputs of one paged-decode case: a pool of random blocks (the sink,
    block 0, random too, so that reading it would show), and per lane a
    table of distinct blocks covering 0..pos, the rest sink entries.  Lane
    1 shares lane 0's first block."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * max_blocks
    q = _normal(seed, (b, 1, h, d), dtype)
    kp, vp = _normal(seed + 1, (nb, bs, g, d), dtype), _normal(seed + 2, (nb, bs, g, d), dtype)
    perm = iter(rng.permutation(np.arange(1, nb)))
    tables = np.zeros((b, max_blocks), np.int32)
    for lane, p in enumerate(pos):
        for i in range(min(p, max_blocks * bs - 1) // bs + 1):
            tables[lane, i] = next(perm)
    if b > 1:
        tables[1, 0] = tables[0, 0]
    return q, kp, vp, tables, np.asarray(pos, np.int32)


def _gather_ref(q, kp, vp, tables, pos, scale):
    """repro's gather reference (models/attention.py decode_attn_paged)."""
    b, _, h, d = q.shape
    bs, g = kp.shape[1], kp.shape[2]
    span = tables.shape[1] * bs
    q, kp, vp = (jnp.asarray(a).astype(jnp.float32) for a in (q, kp, vp))
    ck = kp[tables].reshape(b, span, g, d)
    cv = vp[tables].reshape(b, span, g, d)
    valid = jnp.arange(span)[None, :] <= jnp.asarray(pos)[:, None]
    return sdpa(q, _repeat_kv(ck, h // g), _repeat_kv(cv, h // g), valid[:, None, None, :],
                scale)


@pytest.mark.parametrize("b,h,g,d,bs,max_blocks,pos", [
    (3, 8, 2, 32, 8, 4, [9, 30, 0]),           # ragged, pos 0, shared first block
    (2, 4, 4, 128, 16, 3, [15, 32]),           # H/G 1, D 128, pos on block boundaries
    (4, 8, 2, 32, 4, 5, [19, 3, 12, 8]),       # pos at span - 1, boundaries, sink tails
    (2, 32, 8, 128, 16, 8, [127, 70]),         # granite geometry, H/G 4
    (2, 8, 2, 32, 8, 2, [40, 5]),              # pos past the span: saturates
    (2, 32, 32, 112, 16, 4, [50, 9]),          # zamba2's shared block, head_dim 112
    (3, 16, 4, 112, 8, 5, [33, 0, 12]),        # head_dim 112, GQA, pos 0
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(b, h, g, d, bs, max_blocks, pos, dtype):
    q, kp, vp, tables, pos = _paged_case(len(pos) + d, b, h, g, d, bs, max_blocks, pos, dtype)
    assert (tables[1] == tables[0, 0]).any() and (tables == 0).any()
    scale = d ** -0.5
    out = kpaged.paged_decode_attention_plain(
        *(tensor_from_numpy(a) for a in (q, kp, vp, tables, pos)), scale)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    kern = paged_decode_attention_fwd(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(tables), jnp.asarray(pos), scale=scale,
                                      interpret=True)
    ref = np.asarray(_gather_ref(q, kp, vp, tables, pos, scale))
    got = out.float().numpy()
    if dtype == "float32":
        assert _err(out, kern) < F32_TOL
        assert _err(out, ref) < F32_TOL
    else:                                     # bf16: 2e-2 x max(1, |ref|)
        for r in (np.asarray(kern.astype(jnp.float32)), ref):
            assert (np.abs(got - r) <= BF16_TOL * np.maximum(1.0, np.abs(r))).all()


@pytest.mark.parametrize("b,g,s,sms", [(8, 8, 1024, 132), (1, 1, 64, 132), (2, 8, 4096, 132),
                                       (8, 8, 1000, 132), (64, 8, 128, 132), (1, 2, 65, 4),
                                       (64, 8, 32768, 132)])    # slices at their longest
def test_decode_split_plan_covers_span(b, g, s, sms):
    split_len, n_split = kdec.split_plan(b, g, s, sms)
    assert split_len % kdec.TILE == 0 and split_len <= kdec.MAX_SPLIT
    assert n_split * split_len >= s > (n_split - 1) * split_len     # no empty slice
    # at most one CTA an SM, unless slices would pass MAX_SPLIT
    assert n_split == 1 or b * g * n_split <= sms or split_len > kdec.MAX_SPLIT // 2
    # the span is cut where the pairs leave at least half the SMs idle
    assert n_split > 1 or 2 * b * g > sms or s <= kdec.TILE


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
    pool = k.reshape(5, 8, 2, 32)
    tables = torch.tensor([[3, 1, 0]], dtype=torch.int32)
    pos = torch.tensor([11], dtype=torch.int32)
    assert torch.equal(ops.paged_decode_attention(q[:, :1], pool, pool, tables, pos, 0.2),
                       kpaged.paged_decode_attention_plain(q[:, :1], pool, pool, tables, pos,
                                                           0.2))
    w = torch.full_like(q, 0.9)
    u = torch.zeros(4, 32)
    assert torch.equal(ops.rwkv6_scan(q, q, q, w, u),
                       krwkv.rwkv6_chunked_plain(q, q, q, torch.log(w), u))
    dt, a = torch.full((1, 40, 4), 0.5), -torch.ones(4)
    bc = k[:, :, 0]
    y, st = ops.mamba2_ssd(q, dt, a, bc, bc, torch.ones(4))
    ry, rst = kssd.mamba2_ssd_chunked_plain(q, dt, a, bc, bc, torch.ones(4))
    assert torch.equal(y, ry) and torch.equal(st, rst)
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "paged_decode_attention": 0, "rmsnorm": 0, "rwkv6_scan": 0,
                                   "rwkv6_scan_bwd": 0, "mamba2_ssd": 0}


def test_rwkv6_backward_chooses_the_kernel_by_dtype(monkeypatch):
    """ops' WKV6 autograd node, driven on the CPU with the CUDA wrappers
    stood in by the plain versions: bf16 r/k/v send the backward to
    ``rwkv6_bwd_cuda`` (here the closed form it computes), fp32 ones to
    autograd through the plain version; both give the plain version's
    gradients, every input one (bf16 within 2e-2 x max(1, |ref|))."""
    calls = []

    def bwd(*args):
        calls.append(args[0].dtype)
        return krwkv.rwkv6_chunked_bwd_plain(*args)
    monkeypatch.setattr(krwkv, "rwkv6_cuda", krwkv.rwkv6_chunked_plain)
    monkeypatch.setattr(krwkv, "rwkv6_bwd_cuda", bwd)
    b, t, h, dk = 2, 37, 3, 32
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v = (torch.from_numpy(_normal(i, (b, t, h, dk))).to(dtype) for i in range(3))
        lw = -torch.from_numpy(np.abs(_normal(3, (b, t, h, dk))))
        u, g = torch.from_numpy(_normal(4, (h, dk))), torch.from_numpy(_normal(5, (b, t, h, dk)))
        xs = [a.clone().requires_grad_(True) for a in (r, k, v, lw, u)]
        got = torch.autograd.grad(ops._RWKV6.apply(*xs), xs, g.to(dtype))
        ys = [a.clone().requires_grad_(True) for a in (r, k, v, lw, u)]
        ref = torch.autograd.grad(krwkv.rwkv6_chunked_plain(*ys), ys, g.to(dtype))
        for a, e in zip(got, ref):
            assert a.dtype == e.dtype and a.shape == e.shape
            if dtype == torch.float32:
                assert torch.equal(a, e)
            else:
                err = (a.float() - e.float()).abs()
                assert (err <= 2e-2 * e.float().abs().clamp_min(1.0)).all()
    assert calls == [torch.bfloat16]


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
    with pytest.raises(ValueError, match="CUDA"):
        kpaged.paged_decode_attention_cuda(q[:, :1], q[0, :, :2][None], q[0, :, :2][None],
                                           torch.zeros(1, 1, dtype=torch.int32),
                                           torch.zeros(1, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        krwkv.rwkv6_cuda(q, q, q, q, torch.zeros(4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        krwkv.rwkv6_bwd_cuda(q, q, q, q, torch.zeros(4, 32), q)
    with pytest.raises(ValueError, match="CUDA"):
        kssd.mamba2_ssd_cuda(q, torch.zeros(1, 8, 4), -torch.ones(4), q[:, :, 0], q[:, :, 0],
                             torch.ones(4))
