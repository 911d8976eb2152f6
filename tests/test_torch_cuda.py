"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without an NVIDIA GPU (a CUDA kernel has no CPU mode); imports no
JAX, so it also runs where only the port is installed:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as krms

# |kernel - plain| <= tol * max(1, |plain|): fp32 differs only in summation
# order; bf16 results are rounded to 8 mantissa bits on both sides
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _assert_close(got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    limit = TOLS[dtype] * ref.float().abs().clamp_min(1.0)
    assert torch.isfinite(got.float()).all()
    assert (err <= limit).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 4096), (1, 64), (130, 256), (5, 100)])
def test_rmsnorm_kernel(cuda_device, dtype, rows, d):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x, s = _rand(gen, dtype, rows, d), _rand(gen, dtype, d)
    _assert_close(krms.rmsnorm_cuda(x, s), krms.rmsnorm_plain(x, s), dtype)
    s32 = s.float()                                  # bf16 rows with an fp32 scale
    _assert_close(krms.rmsnorm_cuda(x, s32), krms.rmsnorm_plain(x, s32), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,g,d,causal,chunk", [
    (2, 256, 4, 2, 32, True, 0),
    (1, 200, 4, 4, 64, True, 0),        # MHA + ragged T
    (2, 256, 8, 2, 64, True, 64),       # chunked-local
    (2, 130, 8, 2, 64, True, 48),       # chunk not a tile multiple, ragged
    (1, 128, 2, 1, 32, False, 0),       # non-causal
    (1, 96, 6, 3, 128, True, 0),        # head_dim 128
    (3, 1, 32, 8, 128, True, 0),        # one token
])
def test_flash_kernel(cuda_device, dtype, b, t, h, g, d, causal, chunk):
    gen = torch.Generator(device=cuda_device).manual_seed(t * h)
    q, k, v = _rand(gen, dtype, b, t, h, d), _rand(gen, dtype, b, t, g, d), \
        _rand(gen, dtype, b, t, g, d)
    _assert_close(kfa.flash_attention_cuda(q, k, v, causal=causal, chunk=chunk),
                  kfa.flash_attention_plain(q, k, v, causal=causal, chunk=chunk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,d,span", [(2, 4, 2, 32, 96), (1, 8, 8, 64, 64),
                                          (3, 32, 8, 128, 300), (8, 32, 8, 128, 1024),
                                          (2, 8, 1, 64, 2000)])
def test_decode_kernel(cuda_device, dtype, b, h, g, d, span):
    gen = torch.Generator(device=cuda_device).manual_seed(span)
    q, ck, cv = _rand(gen, dtype, b, 1, h, d), _rand(gen, dtype, b, span, g, d), \
        _rand(gen, dtype, b, span, g, d)
    pos = torch.randint(0, span, (b,), generator=gen, device=cuda_device)
    pos[0] = 0
    valid = torch.arange(span, device=cuda_device)[None] <= pos[:, None]
    _assert_close(kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5),
                  kdec.decode_attention_plain(q, ck, cv, valid, d ** -0.5), dtype)
    scattered = torch.rand((b, span), generator=gen, device=cuda_device) < 0.2
    scattered[:, 0] = True
    _assert_close(kdec.decode_attention_cuda(q, ck, cv, scattered, d ** -0.5),
                  kdec.decode_attention_plain(q, ck, cv, scattered, d ** -0.5), dtype)


@pytest.mark.cuda
def test_ops_launch_kernels_and_count(cuda_device):
    ops.reset_launch_counts()
    x = torch.randn(4, 64, device=cuda_device)
    ops.rmsnorm(x, torch.ones(64, device=cuda_device))
    q = torch.randn(1, 16, 4, 32, device=cuda_device)
    k = torch.randn(1, 16, 2, 32, device=cuda_device)
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :1].contiguous(), k, k,
                         torch.ones(1, 16, dtype=torch.bool, device=cuda_device), 0.2)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1, "decode_attention": 1, "rmsnorm": 1}
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention_cuda(q.transpose(1, 2), k, k)


@pytest.mark.cuda
def test_seeded_sampling_on_the_card_is_placement_independent(cuda_device):
    """Gumbel noise drawn on the card: a lane's draws depend on its seed and
    draw count only, not on which lane or row of the batch it occupies."""
    from repro_torch.serving.sampling import Sampler, SamplingParams
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    logits = 3.0 * _rand(gen, torch.float32, 3, 1000)
    params = [SamplingParams(temperature=2.0, top_k=100, seed=7 + i) for i in range(3)]

    def draws(order, n_lanes):
        sampler = Sampler(n_lanes)
        for row, i in enumerate(order):
            sampler.set_lane(row, params[i])
        out = [sampler.sample(logits[list(order)]) for _ in range(4)]
        return {i: [int(o[row]) for o in out] for row, i in enumerate(order)}
    a = draws((0, 1, 2), 3)
    assert a == draws((0, 1, 2), 3)
    assert a == draws((2, 0, 1), 4)
    assert len({t for toks in a.values() for t in toks}) > 3      # actually stochastic
