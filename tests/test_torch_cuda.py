"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without an NVIDIA GPU (a CUDA kernel has no CPU mode); imports no
JAX, so it also runs where only the port is installed:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import mamba2_ssd as kssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import rwkv6_scan as krwkv
from repro_torch.models.rwkv import rwkv6_scan_plain
from repro_torch.models.ssm import mamba2_scan_plain

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
@pytest.mark.parametrize("rows,d", [
    (37, 4096), (1, 64), (130, 256), (5, 100),
    (1061, 2048),   # a warp per row; 1061 rows: not a multiple of a CTA's 8
    (1100, 4096),   # a warp per row at 16 packs a lane (bf16)
    (1500, 3584),   # zamba2's block norm
    (13, 7168),     # zamba2's gated norm: a CTA per row
    (3, 8192),      # widest CTA-per-row row in bf16; fp32 takes the generic kernel
])
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
    (2, 300, 8, 8, 112, True, 0),       # head_dim 112 (zamba2's shared block), ragged
    (3, 1, 32, 8, 128, True, 0),        # one token
    # the wgmma body (D 112 and 128): 128-key tiles; 4, 2 or 1 query heads
    # of a KV head share a CTA (16, 32 or 64 positions per consumer)
    (2, 129, 32, 8, 128, True, 0),      # one past a 128-key tile
    (1, 257, 32, 8, 128, True, 0),
    (2, 5, 32, 8, 128, True, 0),        # short prompts: T = 1 ... 64
    (2, 16, 32, 8, 128, True, 0),       # granite's smallest bucket: one CTA's 4 x 16 rows
    (1, 17, 32, 8, 128, True, 0),
    (1, 33, 32, 8, 128, True, 0),
    (1, 64, 32, 8, 128, True, 0),
    (1, 77, 4, 2, 112, True, 0),        # D = 112, ragged, 2 heads a consumer
    (2, 129, 32, 32, 112, True, 0),     # zamba2's heads, ragged
    (2, 256, 8, 2, 128, True, 48),      # chunks below a 128-row tile
    (1, 200, 8, 2, 128, True, 64),
    (1, 190, 4, 4, 112, True, 48),
    (1, (100, 300), 4, 2, 128, False, 0),   # Tk != T, non-causal
    (2, (300, 77), 8, 8, 112, False, 0),
    (1, (64, 200), 16, 2, 128, True, 0),    # Tk > T, causal: keys past T unseen
    (2, 130, 4, 4, 128, True, 0),       # H / G = 1
    (1, 200, 16, 4, 128, True, 0),      # H / G = 4
    (1, 100, 32, 4, 128, True, 0),      # H / G = 8: two 4-head groups a KV head
    # zamba2's shared-block prefill as served: one request at its exact length
    (1, 300, 32, 32, 112, True, 0), (1, 37, 32, 32, 112, True, 0),
    # the D = 64 body: few CTAs split the key range (T 1-65 over Tk 1500)
    (1, (1, 1500), 12, 12, 64, False, 0),
    (2, (17, 1500), 12, 12, 64, False, 0),
    (1, (64, 1500), 12, 12, 64, False, 0),
    (1, (65, 1500), 12, 12, 64, False, 0),
    (1, (40, 1500), 14, 2, 64, False, 0),
    (1, (65, 1500), 12, 12, 64, True, 0),
    # ragged T and Tk, and causal with Tk > T
    (1, (77, 300), 8, 2, 64, True, 0),
    (2, (300, 77), 4, 4, 64, False, 0),
    (1, (100, 333), 14, 2, 64, False, 0),
    (1, 1000, 12, 12, 64, False, 0),
    # chunks of 48 and 64
    (1, 300, 8, 8, 64, True, 48),
    (2, 200, 14, 2, 64, True, 64),
    (1, (130, 500), 4, 4, 64, False, 48),
    # H / G 1, 2, 4 and 7 (query heads sharing a consumer's 64 rows: 1, 2, 4, 1)
    (1, 130, 4, 4, 64, True, 0),
    (1, 150, 8, 4, 64, True, 0),
    (2, 100, 16, 4, 64, True, 0),
    (1, 129, 14, 2, 64, True, 0),
])
def test_flash_kernel(cuda_device, dtype, b, t, h, g, d, causal, chunk):
    t, tk = t if isinstance(t, tuple) else (t, t)   # (T, Tk) where they differ
    gen = torch.Generator(device=cuda_device).manual_seed(t * h + tk - t)
    q, k, v = _rand(gen, dtype, b, t, h, d), _rand(gen, dtype, b, tk, g, d), \
        _rand(gen, dtype, b, tk, g, d)
    _assert_close(kfa.flash_attention_cuda(q, k, v, causal=causal, chunk=chunk),
                  kfa.flash_attention_plain(q, k, v, causal=causal, chunk=chunk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,g,d,causal,chunk", [
    (1, 1500, 12, 12, 64, False, 0),            # whisper-small's encoder
    (2, (37, 1500), 12, 12, 64, False, 0),      # its cross-attention: Tk = 1500 frames
    (1, 1088, 14, 2, 64, True, 0),              # internvl2-1b: 1024 rows + 64 tokens, H/G 7
    (1, 300, 40, 8, 128, True, 0),              # llama4-scout: H/G 5
    (1, 8300, 40, 8, 128, True, 8192),          # its chunk edge inside one prompt
    (1, 8193, 40, 8, 128, True, 8192),          # one token past the first chunk
    (1, 8192, 40, 8, 128, True, 8192),          # exactly one chunk
    (1, 600, 48, 8, 128, True, 0),              # grok-1: H/G 6
    (2, 130, 48, 8, 128, True, 0),
    (1, (64, 1500), 12, 12, 64, False, 0),      # whisper's cross-attention, a 64-token prompt
    (4, 1500, 12, 12, 64, False, 0),            # whisper's training microbatch: encoder,
    (4, 448, 12, 12, 64, True, 0),              # decoder self-attention
    (4, (448, 1500), 12, 12, 64, False, 0),     # and cross-attention
])
def test_flash_kernel_at_the_families_shapes(cuda_device, dtype, b, t, h, g, d, causal, chunk):
    test_flash_kernel(cuda_device, dtype, b, t, h, g, d, causal, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_row_with_no_live_key(cuda_device, dtype, d):
    """Chunks of 64 over 200 queries and 100 keys: queries 128-199 lie in a
    chunk that holds no key, and every body returns 0 for them (l == 0).
    The plain version's finite -1e30 mask gives such a row a uniform softmax
    over the keys instead, so the rows with a live key are held to it."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = _rand(gen, dtype, 1, 200, 8, d), _rand(gen, dtype, 1, 100, 2, d), \
        _rand(gen, dtype, 1, 100, 2, d)
    got = kfa.flash_attention_cuda(q, k, v, causal=True, chunk=64)
    _assert_close(got[:, :128], kfa.flash_attention_plain(q, k, v, causal=True, chunk=64)[:, :128],
                  dtype)
    assert (got[:, 128:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,d,span", [
    (8, 40, 8, 128, 8192),      # llama4-scout's ring lanes, H/G 5
    (8, 12, 12, 64, 448),       # whisper-small's self-attention
    (8, 12, 12, 64, 1500),      # and its cross-attention span
    (8, 14, 2, 64, 1536),       # internvl2-1b, H/G 7
    (16, 48, 8, 128, 1024),     # grok-1, H/G 6
])
def test_decode_kernel_at_the_families_shapes(cuda_device, dtype, b, h, g, d, span):
    test_decode_kernel(cuda_device, dtype, b, h, g, d, span)
    gen = torch.Generator(device=cuda_device).manual_seed(span + 3)
    q, ck, cv = _rand(gen, dtype, b, 1, h, d), _rand(gen, dtype, b, span, g, d), \
        _rand(gen, dtype, b, span, g, d)
    every = torch.ones((b, span), dtype=torch.bool, device=cuda_device)   # cross rows
    _assert_close(kdec.decode_attention_cuda(q, ck, cv, every, d ** -0.5),
                  kdec.decode_attention_plain(q, ck, cv, every, d ** -0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,g", [(48, 8), (32, 8)])      # grok-1, mistral-nemo-12b
def test_paged_kernel_at_the_families_shapes(cuda_device, dtype, h, g):
    test_paged_kernel(cuda_device, dtype, 16, h, g, 128, 16, 64,
                      [16 + 63 * i for i in range(16)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1500, 768), (1088, 896), (9000, 5120), (600, 6144),
                                    (16, 6144), (8, 768)])
def test_rmsnorm_kernel_at_the_families_widths(cuda_device, dtype, rows, d):
    test_rmsnorm_kernel(cuda_device, dtype, rows, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,d,span", [(2, 4, 2, 32, 96), (1, 8, 8, 64, 64),
                                          (3, 32, 8, 128, 300), (8, 32, 8, 128, 1024),
                                          (2, 8, 1, 64, 2000),
                                          (2, 32, 32, 112, 300),   # zamba2's shared block
                                          (3, 16, 4, 112, 200),    # head_dim 112, GQA
                                          (8, 32, 32, 112, 1024)])  # zamba2-7b served
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("span", [64, 300, 1024])
def test_decode_kernel_empty_lane_is_mean_of_v(cuda_device, dtype, span):
    """A lane with no valid position returns the mean of V over the span
    (the TPU kernel's finite mask makes its softmax uniform)."""
    b, h, g, d = 3, 32, 8, 128
    gen = torch.Generator(device=cuda_device).manual_seed(span + 1)
    q, ck, cv = _rand(gen, dtype, b, 1, h, d), _rand(gen, dtype, b, span, g, d), \
        _rand(gen, dtype, b, span, g, d)
    valid = torch.arange(span, device=cuda_device)[None] <= torch.tensor(
        [[span // 2], [-1], [0]], device=cuda_device)
    got = kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5)
    _assert_close(got, kdec.decode_attention_plain(q, ck, cv, valid, d ** -0.5), dtype)
    mean_v = cv[1].float().mean(0).repeat_interleave(h // g, dim=0)        # (H, D)
    _assert_close(got[1, 0], mean_v, dtype)


def _paged_inputs(gen, dtype, b, h, g, d, bs, max_blocks, pos):
    """A pool with the sink (block 0) random too, per-lane tables of
    distinct blocks drawn from a permutation, lane 1 sharing lane 0's first
    block, sink entries past each lane's blocks."""
    dev = gen.device
    nb = 1 + b * max_blocks
    q = _rand(gen, dtype, b, 1, h, d)
    kp, vp = _rand(gen, dtype, nb, bs, g, d), _rand(gen, dtype, nb, bs, g, d)
    perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((b, max_blocks), dtype=torch.int32)
    for lane, p in enumerate(pos):
        n = min(p, max_blocks * bs - 1) // bs + 1
        tables[lane, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    if b > 1:
        tables[1, 0] = tables[0, 0]
    return q, kp, vp, tables.to(dev), torch.tensor(pos, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,d,bs,max_blocks,pos", [
    (3, 8, 2, 32, 8, 4, [9, 30, 0]),
    (2, 4, 4, 128, 16, 3, [15, 32]),
    (4, 8, 2, 64, 4, 5, [19, 3, 12, 8]),
    (16, 32, 8, 128, 16, 64, [16 + 63 * i for i in range(16)]),
    (2, 8, 2, 32, 8, 2, [40, 5]),
    (2, 32, 32, 112, 16, 8, [100, 7]),         # zamba2's shared block, head_dim 112
    (3, 16, 4, 112, 16, 5, [70, 0, 33]),       # head_dim 112, GQA
    (16, 32, 8, 128, 16, 64, [1023] + [16] * 15),   # one long lane among short ones
])
def test_paged_kernel(cuda_device, dtype, b, h, g, d, bs, max_blocks, pos):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(pos))
    args = _paged_inputs(gen, dtype, b, h, g, d, bs, max_blocks, pos)
    _assert_close(kpaged.paged_decode_attention_cuda(*args, d ** -0.5),
                  kpaged.paged_decode_attention_plain(*args, d ** -0.5), dtype)


def _scratch_counters(t):
    """The merge counters the decode wrappers keep for the current stream of
    ``t``'s device."""
    held = kdec._SCRATCH[(t.device.index, torch.cuda.current_stream(t.device).cuda_stream)]
    return held.tensors[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_calls_repeat_and_leave_counters_at_zero(cuda_device, dtype):
    """The kept counters return to 0 after every call (no memset between
    calls), so back-to-back calls give equal outputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    b, h, g, d, span = 4, 32, 8, 128, 1024
    q, ck, cv = _rand(gen, dtype, b, 1, h, d), _rand(gen, dtype, b, span, g, d), \
        _rand(gen, dtype, b, span, g, d)
    valid = torch.arange(span, device=cuda_device)[None] <= torch.tensor(
        [[900], [5], [-1], [512]], device=cuda_device)
    args = _paged_inputs(gen, dtype, 4, h, g, d, 16, 64, [1000, 3, 600, 64])
    for _ in range(2):
        first = kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5)
        second = kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        assert not _scratch_counters(q).any()
        paged = [kpaged.paged_decode_attention_cuda(*args, d ** -0.5) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(paged[0], paged[1])
        assert not _scratch_counters(q).any()
    _assert_close(first, kdec.decode_attention_plain(q, ck, cv, valid, d ** -0.5), dtype)
    _assert_close(paged[0], kpaged.paged_decode_attention_plain(*args, d ** -0.5), dtype)


@pytest.mark.cuda
def test_decode_scratch_large_small_large(cuda_device):
    """A large call, a small one, then a large one again, on the scratch the
    wrappers keep (grown by the first): each equals its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    dtype = torch.bfloat16
    for b, h, g, d, span in ((16, 64, 8, 128, 2048), (1, 4, 2, 32, 64), (16, 64, 8, 128, 2048),
                             (2, 32, 32, 112, 700)):
        q, ck, cv = _rand(gen, dtype, b, 1, h, d), _rand(gen, dtype, b, span, g, d), \
            _rand(gen, dtype, b, span, g, d)
        pos = torch.randint(0, span, (b,), generator=gen, device=cuda_device)
        valid = torch.arange(span, device=cuda_device)[None] <= pos[:, None]
        _assert_close(kdec.decode_attention_cuda(q, ck, cv, valid, d ** -0.5),
                      kdec.decode_attention_plain(q, ck, cv, valid, d ** -0.5), dtype)
        args = _paged_inputs(gen, dtype, b, h, g, d, 16, span // 16, pos.tolist())
        _assert_close(kpaged.paged_decode_attention_cuda(*args, d ** -0.5),
                      kpaged.paged_decode_attention_plain(*args, d ** -0.5), dtype)
        torch.cuda.synchronize()
        assert not _scratch_counters(q).any()


@pytest.mark.cuda
def test_flash_split_calls_repeat_and_leave_counters_at_zero(cuda_device):
    """Flash's D = 64 body at whisper's cross-attention (12 query tiles over
    1500 keys: the key range cut into slices) merges through the scratch the
    decode wrappers keep: back-to-back calls, with a decode call between
    them on the same scratch, give bit-equal outputs (the merge's order does
    not depend on which CTA merges) and leave every counter at 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    dtype = torch.bfloat16
    q, k, v = _rand(gen, dtype, 1, 64, 12, 64), _rand(gen, dtype, 1, 1500, 12, 64), \
        _rand(gen, dtype, 1, 1500, 12, 64)
    assert kfa.split_plan(1, 64, 1500, 12, 12, False, 0, kdec.n_sms(cuda_device)) > 1
    outs = [kfa.flash_attention_cuda(q, k, v, causal=False) for _ in range(2)]
    dq, dk, dv = _rand(gen, dtype, 8, 1, 12, 64), _rand(gen, dtype, 8, 1500, 12, 64), \
        _rand(gen, dtype, 8, 1500, 12, 64)
    kdec.decode_attention_cuda(dq, dk, dv, torch.ones((8, 1500), dtype=torch.bool,
                                                      device=cuda_device), 0.125)
    outs.append(kfa.flash_attention_cuda(q, k, v, causal=False))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not _scratch_counters(q).any()
    _assert_close(outs[0], kfa.flash_attention_plain(q, k, v, causal=False), dtype)


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, kp, vp, tables, pos = _paged_inputs(gen, torch.float32, 2, 8, 2, 32, 8, 4, [9, 3])
    with pytest.raises(TypeError, match="int32"):
        kpaged.paged_decode_attention_cuda(q, kp, vp, tables.long(), pos, 0.1)
    with pytest.raises(TypeError, match="share"):
        kpaged.paged_decode_attention_cuda(q, kp.bfloat16(), vp, tables, pos, 0.1)
    with pytest.raises(ValueError, match="shapes"):
        kpaged.paged_decode_attention_cuda(q, kp, vp, tables[:1], pos, 0.1)


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
    pool = k.reshape(4, 4, 2, 32)
    ops.paged_decode_attention(q[:, :1].contiguous(), pool, pool,
                               torch.tensor([[2, 1]], dtype=torch.int32, device=cuda_device),
                               torch.tensor([6], dtype=torch.int32, device=cuda_device), 0.2)
    ops.rwkv6_scan(q, q, q, torch.full_like(q, 0.9), torch.zeros(4, 32, device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ops.mamba2_ssd(*_ssd_inputs(gen, torch.float32, 1, 16, 2, 32, 16, "reference"))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1, "decode_attention": 1,
                                   "paged_decode_attention": 1, "rmsnorm": 1, "rwkv6_scan": 1,
                                   "mamba2_ssd": 1}
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


def _rwkv_inputs(gen, dtype, b, t, h, dk, min_log_decay):
    """r/k/v in ``dtype``; fp32 log-decay uniform in [min_log_decay, 0]; u ~ 0.3 N."""
    r, k, v = (_rand(gen, dtype, b, t, h, dk) for _ in range(3))
    lw = min_log_decay * torch.rand((b, t, h, dk), generator=gen, device=gen.device)
    return r, k, v, lw, 0.3 * _rand(gen, torch.float32, h, dk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dk,min_log_decay", [
    (2, 128, 4, 32, -0.5),
    (1, 100, 2, 64, -0.5),              # T not a multiple of the chunk
    (2, 37, 3, 32, -0.1),               # T shorter than three chunks, ragged
    (1, 1, 2, 64, -0.5),                # one token
    (8, 512, 32, 64, -0.05),            # rwkv6-1.6b's training shape
    (1, 200, 2, 64, -5.0),              # strong decay: the TPU formula overflows
    # the bf16 body's edges: chunks of 64 in sub-blocks and 8-token halves of
    # 16, V halves of 32 (K 64) and 16 (K 32); odd head counts
    (1, 17, 3, 64, -0.5), (2, 63, 5, 64, -0.5), (1, 65, 3, 32, -0.5), (1, 500, 5, 32, -1.0),
    (2, 1, 5, 32, -0.5),
    # rwkv6-1.6b's prefill as served: one request at its exact length
    (1, 37, 32, 64, -0.5), (1, 63, 32, 64, -0.5), (1, 600, 32, 64, -0.05),
])
def test_rwkv6_kernel(cuda_device, dtype, b, t, h, dk, min_log_decay):
    """Kernel against the plain chunked version: fp32 within 3e-5 of
    max|ref| (the reference kernel's tolerance), bf16 within 2e-2 x
    max(1, |ref|); fp32 also against the token recurrence."""
    gen = torch.Generator(device=cuda_device).manual_seed(t * h + dk)
    r, k, v, lw, u = _rwkv_inputs(gen, dtype, b, t, h, dk, min_log_decay)
    got = krwkv.rwkv6_cuda(r, k, v, lw, u)
    ref = krwkv.rwkv6_chunked_plain(r, k, v, lw, u)
    assert torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        _assert_close(got, ref, dtype)
        return
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= 3e-5 * scale
    if t <= 200:
        rec, _ = rwkv6_scan_plain(r, k, v, torch.exp(lw), u)
        assert (got - rec).abs().max() <= 3e-5 * rec.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("t,dk", [(200, 64), (130, 32)])
def test_rwkv6_kernel_bf16_holds_to_the_recurrence_under_strong_decay(cuda_device, t, dk):
    """bf16 inputs with per-step log-decay down to -5 (a 64-token chunk's sum
    reaches ~ -160): the tensor-core body against the token recurrence of
    the same bf16 values within 2e-2 x max(1, |ref|)."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + dk)
    r, k, v, lw, u = _rwkv_inputs(gen, torch.bfloat16, 2, t, 3, dk, -5.0)
    got = krwkv.rwkv6_cuda(r, k, v, lw, u)
    rec, _ = rwkv6_scan_plain(r.float(), k.float(), v.float(), torch.exp(lw), u)
    _assert_close(got, rec, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dk", [64, 32])
def test_rwkv6_kernel_bf16_holds_a_large_state_whose_out_rows_cancel(cuda_device, dk):
    """Decay near 1 and k, v of one sign grow the state to ~2e3 over 512
    tokens while each r row sums to ~0, so out rows cancel to O(1), as in
    rwkv6-1.6b after a few training steps: the tensor-core body against the
    token recurrence within 2e-2 x max(1, |ref|).  Its inter term needs
    fp32's 24 bits for this (hi + lo bf16 operands are not enough)."""
    gen = torch.Generator(device=cuda_device).manual_seed(dk)
    shape = (1, 512, 2, dk)
    x = _rand(gen, torch.float32, *shape)
    r = (x - x.mean(-1, keepdim=True)).bfloat16()
    k, v = ((2 + 0.5 * _rand(gen, torch.float32, *shape)).bfloat16() for _ in range(2))
    lw = -0.002 * torch.rand(shape, generator=gen, device=cuda_device)
    u = 0.3 * _rand(gen, torch.float32, 2, dk)
    got = krwkv.rwkv6_cuda(r, k, v, lw, u)
    rec, _ = rwkv6_scan_plain(r.float(), k.float(), v.float(), torch.exp(lw), u)
    assert rec.abs().max() > 100
    _assert_close(got, rec, torch.bfloat16)


@pytest.mark.cuda
def test_rwkv6_kernel_takes_rows_that_are_not_16_byte_aligned(cuda_device):
    """Contiguous inputs that start one element past an aligned address take
    the bodies' element-by-element staging; the same values as aligned ones."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    args = _rwkv_inputs(gen, torch.bfloat16, 2, 70, 3, 64, -1.0)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        return out
    moved = [shifted(a) for a in args[:4]]
    assert all(a.data_ptr() % 16 for a in moved)
    assert torch.equal(krwkv.rwkv6_cuda(*moved, args[4]), krwkv.rwkv6_cuda(*args))


@pytest.mark.cuda
def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r, k, v, lw, u = _rwkv_inputs(gen, torch.float32, 1, 16, 2, 32, -0.5)
    with pytest.raises(TypeError, match="share"):
        krwkv.rwkv6_cuda(r, k.bfloat16(), v, lw, u)
    with pytest.raises(TypeError, match="float32"):
        krwkv.rwkv6_cuda(r, k, v, lw.bfloat16(), u)
    with pytest.raises(ValueError, match="head dims"):
        krwkv.rwkv6_cuda(*(a[..., :16].contiguous() for a in (r, k, v, lw)), u[:, :16].contiguous())
    with pytest.raises(ValueError, match="head dims"):
        krwkv.rwkv6_cuda(*(a.repeat(1, 1, 1, 4) for a in (r, k, v, lw)), u.repeat(1, 4))
    with pytest.raises(ValueError, match="contiguous"):
        krwkv.rwkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, lw, u)
    with pytest.raises(ValueError, match="shapes"):
        krwkv.rwkv6_cuda(r, k, v, lw, u[:1])


def _grads(fn, xs, seed=1):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    g = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(seed),
                    device=out.device).to(out.dtype)
    return torch.autograd.grad(out, xs, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_through_the_kernels_match_plain(cuda_device, dtype):
    """The autograd wrappers of ops (kernel forward, backward through the
    plain version) give the plain versions' gradients: every input gets
    one, within the forward tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = _rand(gen, dtype, 2, 80, 4, 32), _rand(gen, dtype, 2, 80, 2, 32), \
        _rand(gen, dtype, 2, 80, 2, 32)
    x, s = _rand(gen, dtype, 24, 256), 1 + 0.1 * _rand(gen, dtype, 256)
    r, kk, vv, lw, u = _rwkv_inputs(gen, dtype, 2, 40, 2, 32, -1.0)
    w = torch.exp(lw)
    ssd = _ssd_inputs(gen, dtype, 2, 70, 3, 32, 16, "reference")
    cases = [
        (lambda *a: ops.flash_attention(*a), lambda *a: kfa.flash_attention_plain(*a),
         [q, k, v]),
        (lambda *a: ops.rmsnorm(*a), lambda *a: krms.rmsnorm_plain(*a), [x, s]),
        (lambda *a: ops.rwkv6_scan(*a),
         lambda r, k, v, w, u: krwkv.rwkv6_chunked_plain(
             r, k, v, torch.log(torch.clamp(w.float(), min=1e-38)), u), [r, kk, vv, w, u]),
        (lambda *a: ops.mamba2_ssd(*a)[0], lambda *a: kssd.mamba2_ssd_chunked_plain(*a)[0],
         list(ssd)),
    ]
    ops.reset_launch_counts()
    for fn, plain, xs in cases:
        for a, b in zip(_grads(fn, xs), _grads(plain, xs)):
            assert a is not None and a.shape == b.shape
            _assert_close(a, b, a.dtype)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["rmsnorm"] == counts["rwkv6_scan"] == 1
    assert counts["mamba2_ssd"] == 1


@pytest.mark.cuda
def test_serving_kernels_refuse_inputs_that_need_a_gradient(cuda_device):
    q = torch.randn(1, 1, 4, 32, device=cuda_device, requires_grad=True)
    ck = torch.randn(1, 8, 2, 32, device=cuda_device)
    valid = torch.ones(1, 8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, ck, ck, valid, 0.2)
    pool = ck.reshape(2, 4, 2, 32)
    args = (pool, pool, torch.tensor([[1, 0]], dtype=torch.int32, device=cuda_device),
            torch.tensor([3], dtype=torch.int32, device=cuda_device), 0.2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_decode_attention(q, *args)
    with torch.no_grad():
        ops.decode_attention(q, ck, ck, valid, 0.2)
        ops.paged_decode_attention(q, *args)


@pytest.mark.cuda
def test_ops_skip_autograd_when_no_gradient_is_needed(cuda_device):
    """Under no_grad, or on inputs that need no gradient, the wrapped ops
    launch their kernel directly (no graph node); with a gradient needed
    they return a tensor autograd can differentiate."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, s = _rand(gen, torch.float32, 8, 256), _rand(gen, torch.float32, 256)
    q = _rand(gen, torch.float32, 1, 16, 2, 32)
    r, k, v, lw, u = _rwkv_inputs(gen, torch.float32, 1, 16, 2, 32, -0.5)
    calls = [lambda x, s: ops.rmsnorm(x, s), lambda q: ops.flash_attention(q, q, q),
             lambda r, k, v, w, u: ops.rwkv6_scan(r, k, v, w, u),
             lambda *a: ops.mamba2_ssd(*a)[0]]
    inputs = [[x, s], [q], [r, k, v, torch.exp(lw), u],
              list(_ssd_inputs(gen, torch.float32, 1, 16, 2, 32, 16, "reference"))]
    ops.reset_launch_counts()
    for fn, xs in zip(calls, inputs):
        assert fn(*xs).grad_fn is None
        with torch.no_grad():
            assert fn(*(a.detach().requires_grad_(True) for a in xs)).grad_fn is None
        assert fn(*(a.detach().requires_grad_(True) for a in xs)).grad_fn is not None
    assert ops.launch_counts() == {"flash_attention": 3, "decode_attention": 0,
                                   "paged_decode_attention": 0, "rmsnorm": 3, "rwkv6_scan": 3,
                                   "mamba2_ssd": 3}


def _ssd_inputs(gen, dtype, b, t, h, p, n, decay):
    """x, dt, A, B, C, D for the SSD scan; x, B and C in ``dtype`` and cut
    from one (B, T, H*P + 2N) tensor as the model cuts them (strided views).
    ``decay``: "reference" (dt = softplus(N(0,1)), A = -exp(0.3 N), as
    tests/test_kernels.py) or "strong" (dt uniform in [0, 5], A = -16)."""
    dev = gen.device
    xbc = _rand(gen, dtype, b, t, h * p + 2 * n)
    x = xbc[..., :h * p].reshape(b, t, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    if decay == "strong":
        dt = 5.0 * torch.rand((b, t, h), generator=gen, device=dev)
        a = torch.full((h,), -16.0, device=dev)
    else:
        dt = torch.nn.functional.softplus(_rand(gen, torch.float32, b, t, h))
        a = -torch.exp(0.3 * _rand(gen, torch.float32, h))
    return x, dt, a, bm, cm, 1.0 + 0.1 * _rand(gen, torch.float32, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,decay", [
    (2, 128, 4, 32, 16, "reference"),   # zamba2 reduced widths
    (1, 100, 3, 64, 64, "reference"),   # zamba2 full widths, T not a multiple of the chunk
    (2, 37, 2, 64, 64, "reference"),    # shorter than one chunk
    (1, 1, 2, 32, 16, "reference"),     # one token
    (2, 500, 4, 64, 64, "strong"),      # strong decay, ragged: a chunk's log-decay ~ -5000
    (8, 512, 112, 64, 64, "reference"),  # zamba2-7b's training shape
    # the bf16 body's edges: head groups of 2 (odd H leaves one short),
    # chunks of 64, rows of P in blocks of 16 (P = 32 fills half the warps)
    (1, 17, 5, 64, 64, "reference"), (2, 63, 3, 64, 64, "reference"),
    (1, 65, 5, 64, 64, "reference"), (1, 500, 3, 64, 64, "reference"),
    (2, 65, 3, 32, 16, "reference"), (1, 17, 5, 32, 16, "strong"),
    # zamba2-7b's prefill as served: one request at its exact length
    (1, 37, 112, 64, 64, "reference"), (1, 63, 112, 64, 64, "reference"),
    (1, 600, 112, 64, 64, "reference"),
])
def test_ssd_kernel(cuda_device, dtype, b, t, h, p, n, decay):
    """Kernel against the plain chunked version (y and the final state):
    fp32 within 3e-5 of max|ref| (the reference kernel's tolerance), also
    against the token recurrence; bf16 y within 2e-2 x max(1, |ref|)."""
    gen = torch.Generator(device=cuda_device).manual_seed(t * h + p + n)
    args = _ssd_inputs(gen, dtype, b, t, h, p, n, decay)
    y, s = kssd.mamba2_ssd_cuda(*args)
    ry, rs = kssd.mamba2_ssd_chunked_plain(*args)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    assert (s - rs).abs().max() <= 3e-5 * rs.abs().max()
    if dtype == torch.bfloat16:
        _assert_close(y, ry, dtype)
        return
    assert (y - ry).abs().max() <= 3e-5 * ry.abs().max()
    if t * h <= 2000:
        qy, qs = mamba2_scan_plain(*args)
        assert (y - qy).abs().max() <= 3e-5 * qy.abs().max()
        assert (s - qs).abs().max() <= 3e-5 * qs.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("t,p,n", [(500, 64, 64), (130, 32, 16)])
def test_ssd_kernel_bf16_holds_to_the_recurrence_under_strong_decay(cuda_device, t, p, n):
    """bf16 inputs with dt up to 5 at A = -16 (a chunk's log-decay reaches
    ~ -5000): the tensor-core body against the token recurrence of the same
    bf16 values, y within 2e-2 x max(1, |ref|) and the fp32 final state
    within 3e-5 x max|ref|."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + p)
    args = _ssd_inputs(gen, torch.bfloat16, 2, t, 3, p, n, "strong")
    y, s = kssd.mamba2_ssd_cuda(*args)
    qy, qs = mamba2_scan_plain(*(a.float() for a in args))
    _assert_close(y, qy, torch.bfloat16)
    assert torch.isfinite(s).all() and (s - qs).abs().max() <= 3e-5 * qs.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_strides_that_are_not_16_byte_aligned(cuda_device, dtype):
    """x, B and C cut from a conv output one column wider than the model's,
    so no token row starts 16-byte aligned: the element-by-element staging,
    held to the plain version as test_ssd_kernel holds the aligned one."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    b, t, h, p, n = 2, 100, 3, 64, 64
    x, dt, a, _, _, d = _ssd_inputs(gen, dtype, b, t, h, p, n, "reference")
    xbc = _rand(gen, dtype, b, t, h * p + 2 * n + 1)
    x = xbc[..., 1:h * p + 1].reshape(b, t, h, p)
    bm, cm = xbc[..., h * p + 1:h * p + n + 1], xbc[..., h * p + n + 1:]
    assert x.data_ptr() % 16 and x.stride(1) % 8
    args = (x, dt, a, bm, cm, d)
    y, s = kssd.mamba2_ssd_cuda(*args)
    ry, rs = kssd.mamba2_ssd_chunked_plain(*args)
    assert (s - rs).abs().max() <= 3e-5 * rs.abs().max()
    if dtype == torch.bfloat16:
        _assert_close(y, ry, dtype)
    else:
        assert (y - ry).abs().max() <= 3e-5 * ry.abs().max()


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, dt, a, bm, cm, d = _ssd_inputs(gen, torch.float32, 1, 16, 2, 32, 16, "reference")
    with pytest.raises(TypeError, match="share"):
        kssd.mamba2_ssd_cuda(x, dt, a, bm.bfloat16(), cm, d)
    with pytest.raises(TypeError, match="float32"):
        kssd.mamba2_ssd_cuda(x, dt.bfloat16(), a, bm, cm, d)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        kssd.mamba2_ssd_cuda(x[..., :16], dt, a, bm, cm, d)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        kssd.mamba2_ssd_cuda(x, dt, a, bm[..., :8], cm[..., :8], d)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        kssd.mamba2_ssd_cuda(*_ssd_inputs(gen, torch.float32, 1, 16, 2, 64, 16, "reference"))
    with pytest.raises(ValueError, match="packed"):
        kssd.mamba2_ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm, d)
    with pytest.raises(ValueError, match="shapes"):
        kssd.mamba2_ssd_cuda(x, dt, a[:1], bm, cm, d)
    with pytest.raises(ValueError, match="CUDA"):
        kssd.mamba2_ssd_cuda(x, dt.cpu(), a, bm, cm, d)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_recurrent_serving_takes_the_scan_kernels_and_matches_the_cpu(cuda_device, arch):
    """Reduced rwkv6 / zamba2, fp32: a prefill on the card launches the WKV6
    or SSD kernel once a layer (flash once a shared-block firing), a decode
    step no scan kernel (the decode kernel once a firing); logits and every
    state leaf within 1e-4 x max(1, |ref|) of the CPU model's."""
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.convert import move_params
    from repro_torch.models.api import build_model
    from repro_torch.models.blocks import n_attn_applications
    from repro_torch.serving.backends import lane_leaves

    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), n_layers=4)
    rcfg = tconfigs.RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    cpu, gpu = build_model(cfg, rcfg, device="cpu"), build_model(cfg, rcfg, device=cuda_device)
    p_cpu = cpu.init(0)
    p_gpu = move_params(p_cpu, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (1, 37), generator=torch.Generator().manual_seed(3))
    scan = "rwkv6_scan" if cfg.rwkv else "mamba2_ssd"
    n_attn = n_attn_applications(cfg)
    with torch.no_grad():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 64)
        ops.reset_launch_counts()
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.to(cuda_device)}, 64)
        assert ops.launch_counts()[scan] == cfg.n_layers
        assert ops.launch_counts()["flash_attention"] == n_attn
        nxt = torch.argmax(l_c, -1)[:, None]
        l_c2, c_c2 = cpu.decode_step(p_cpu, c_c, nxt)
        ops.reset_launch_counts()
        l_g2, c_g2 = gpu.decode_step(p_gpu, c_g, nxt.to(cuda_device))
        assert ops.launch_counts()[scan] == 0
        assert ops.launch_counts()["decode_attention"] == n_attn
    _assert_close(l_g.cpu(), l_c, torch.float32)
    _assert_close(l_g2.cpu(), l_c2, torch.float32)
    ref = lane_leaves(c_c2, 0)
    for path, leaf in lane_leaves(c_g2, 0).items():
        _assert_close(leaf.cpu().float(), ref[path].float(), torch.float32)


def _reduced_granite(dtype, device, n_layers=4):
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite-8b")),
                              n_layers=n_layers)
    rcfg = tconfigs.RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False)
    return build_model(cfg, rcfg, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cuts", [(2,), (1, 3)], ids=str)
def test_stage_composition_on_the_card_equals_the_full_model(cuda_device, dtype, cuts):
    """Layer-range stages composed through a codec round trip of the
    boundary hidden are bit-identical to the card's full model: prefill
    logits and two decode steps at B=2, the same kernels on the same shapes;
    a cut adds no kernel launch."""
    from repro_torch.models.api import split_stage_params, stage_model
    from repro_torch.wire import codec

    model = _reduced_granite(dtype, cuda_device)
    params = model.init(0)
    bounds = (0,) + cuts + (model.cfg.n_layers,)
    stages = [stage_model(model, bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    sps = split_stage_params(model, params, cuts)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(1)).to(cuda_device)

    def ship(x):
        return codec.loads(codec.dumps(x)).to(cuda_device)

    with torch.no_grad():
        ops.reset_launch_counts()
        want, cache = model.prefill(params, {"tokens": toks}, 64)
        full_counts = ops.launch_counts()
        ops.reset_launch_counts()
        x, caches = None, []
        for i, (sm, sp) in enumerate(zip(stages, sps)):
            x, c = sm.prefill(sp, {"tokens": toks} if i == 0 else {"hidden": ship(x)}, 64)
            caches.append(c)
        assert ops.launch_counts() == full_counts
        assert torch.equal(want, x)
        for tok in (5, 17):
            t = torch.full((2, 1), tok, device=cuda_device)
            want, cache = model.decode_step(params, cache, t)
            x = t
            for i, (sm, sp) in enumerate(zip(stages, sps)):
                x, caches[i] = sm.decode_step(sp, caches[i], x if i == 0 else ship(x))
            assert torch.equal(want, x), tok


@pytest.mark.cuda
def test_pipeline_engine_on_the_card_matches_the_cpu(cuda_device):
    """fp32: a 2-stage PipelineEngine on the card, recut to 3 stages midway,
    serves the CPU engine's greedy tokens with the same frame bytes."""
    import numpy as np

    from repro_torch.convert import move_params
    from repro_torch.serving.pipeline_decode import PipelineEngine

    cpu, gpu = _reduced_granite("float32", "cpu"), _reduced_granite("float32", cuda_device)
    p_cpu = cpu.init(0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cpu.cfg.vocab_size, size=n) for n in (5, 17, 33, 9, 60)]
    runs = []
    for model, params in ((cpu, p_cpu), (gpu, move_params(p_cpu, cuda_device))):
        eng = PipelineEngine(model, params, max_batch=3, max_len=128, cuts=(2,))
        for p in prompts:
            eng.submit(p, max_new=8)
        for _ in range(3):
            eng.step()
        moved = eng.recut((1, 3))
        done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        runs.append((done, moved, eng.prefill_frame_bytes_total, eng.decode_frame_bytes_total))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == len(prompts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["granite-8b", "rwkv6-1.6b", "paged"])
def test_verify_window_is_bitwise_w_single_steps_on_the_card(cuda_device, dtype, family):
    """The speculative verify window (a loop of the single-step call) gives
    logits and a cache bitwise equal to W separate decode steps on the
    card, through the decode kernels, for dense lanes, the block pool and
    rwkv6's recurrent state."""
    import dataclasses

    import repro_torch.configs as tconfigs
    from repro_torch.models.api import build_model

    arch = "granite-8b" if family == "paged" else family
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), n_layers=4)
    rcfg = tconfigs.RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False)
    model = build_model(cfg, rcfg, device=cuda_device)
    params = model.init(0)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (3, 21), generator=gen).to(cuda_device)
    nxt = torch.randint(0, cfg.vocab_size, (3, 4), generator=gen).to(cuda_device)
    ds = model.decode_state

    def fresh():
        if family != "paged":
            return model.prefill(params, {"tokens": toks}, 64)[1]
        cache = ds.pool_init(3, 16, 8)
        for name in ("k", "v"):
            cache["layers"][name].copy_(_rand(torch.Generator(device=cuda_device)
                                              .manual_seed(5), cache["layers"][name].dtype,
                                              *cache["layers"][name].shape))
        cache["pos"].copy_(torch.tensor([5, 0, 17], dtype=torch.int32))
        return cache
    tables = torch.arange(1, 13, dtype=torch.int32, device=cuda_device).reshape(3, 4)
    with torch.no_grad():
        ops.reset_launch_counts()
        if family == "paged":
            wl, wc = ds.pool_window_step(params, fresh(), nxt, tables)
        else:
            wl, wc = ds.window_step(params, fresh(), nxt)
        window_counts = ops.launch_counts()
        ops.reset_launch_counts()
        c, steps = fresh(), []
        for j in range(nxt.shape[1]):
            if family == "paged":
                lg, c = ds.pool_step(params, c, nxt[:, j:j + 1], tables)
            else:
                lg, c = model.decode_step(params, c, nxt[:, j:j + 1])
            steps.append(lg)
        step_counts = ops.launch_counts()
    assert window_counts == step_counts
    assert sum(step_counts.values()) > 0
    assert torch.equal(wl, torch.stack(steps, 1))
    for name in wc["layers"]:
        assert torch.equal(wc["layers"][name], c["layers"][name]), name
    assert torch.equal(wc["pos"], c["pos"])


@pytest.mark.cuda
def test_accept_samples_on_the_logits_device(cuda_device):
    """Coupled acceptance draws a stochastic lane's tokens on the card, as
    ``Sampler.sample`` does in the plain engine: window position by position
    it equals ``sample`` on the card's logits (the CPU generator draws other
    bits), and a SpecEngine whose draft is the target itself is accepted
    wholesale and serves the card's plain ServeEngine tokens (both engines
    prefill each request alone at its exact length)."""
    import numpy as np

    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.sampling import Sampler, SamplingParams
    from repro_torch.serving.speculative import SpecEngine

    def lanes():
        s = Sampler(4)
        for lane in (1, 3):
            s.set_lane(lane, SamplingParams(temperature=1.5, top_k=20, seed=lane))
        return s
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    logits = _rand(gen, torch.float32, 4, 3, 97)
    drafted = np.zeros((4, 2), np.int32)
    emitted, n_emitted, _ = lanes().accept(logits, drafted, np.ones(4, bool), [3] * 4)
    ref = lanes()
    for i in range(4):
        for j in range(int(n_emitted[i])):
            mask = np.arange(4) == i
            want = int(ref.sample(logits[:, j], mask=mask)[i])
            assert emitted[i][j] == want, (i, j)

    model = _reduced_granite("float32", cuda_device)
    params = model.init(0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n) for n in (5, 17, 33, 9)]
    samp = [None, SamplingParams(temperature=2.0, top_k=40, seed=7), None,
            SamplingParams(temperature=2.0, seed=8)]
    # every prefill alone at its exact length, as the draft side prefills:
    # the draft's cache is then bitwise the target's
    kw = dict(max_batch=4, max_len=128, prefill_buckets=range(1, 129), max_prefill_batch=1)
    runs = []
    for eng in (ServeEngine(model, params, **kw),
                SpecEngine(model, params, model, params, spec_k=3, **kw)):
        rids = [eng.submit(p, max_new=10, sampling=s) for p, s in zip(prompts, samp)]
        done = {r.rid: r.out_tokens for r in eng.run_until_drained()}
        runs.append([done[r] for r in rids])
    assert runs[0] == runs[1]
    assert eng.metrics_snapshot().spec_acceptance_rate == 1.0


@pytest.mark.cuda
def test_fleet_kill_on_the_card_matches_the_cpu(cuda_device):
    """fp32: a two-worker ServingFleet on the card, one worker crashing
    mid-decode (a seeded kill trace), serves the CPU fleet's greedy tokens
    and reads the same FleetSnapshot, deaths and resurrections included."""
    import numpy as np

    from repro_torch.convert import move_params
    from repro_torch.hw.specs import DeviceProfile
    from repro_torch.runtime.faults import make_kill_trace
    from repro_torch.serving.fleet import ServingFleet, WorkerSpec, drive_sim

    prof = DeviceProfile(name="dev", year=2024, flops=1e12, mem_bytes=8e9, mem_bw=60e9,
                         link_bw=1e9, decode_steps_per_s=20.0, prefill_tokens_per_s=1e9)
    cpu, gpu = _reduced_granite("float32", "cpu"), _reduced_granite("float32", cuda_device)
    p_cpu = cpu.init(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cpu.cfg.vocab_size, size=6 + i) for i in range(6)]
    runs = []
    for model, params in ((cpu, p_cpu), (gpu, move_params(p_cpu, cuda_device))):
        fleet = ServingFleet(model, params, [WorkerSpec(n, prof, max_batch=4) for n in "ab"],
                             max_len=48, tick_s=0.05,
                             kill_trace=make_kill_trace(["b"], 1, t0_s=0.4, t1_s=0.6, seed=3))
        drive_sim(fleet, np.linspace(0.0, 0.3, len(prompts)),
                  lambda i: fleet.submit(prompts[i], max_new=8))
        snap = fleet.snapshot()
        assert snap.completed == len(prompts) and snap.deaths == 1
        assert snap.resurrections >= 1 and snap.orphaned == 0
        d = snap.as_dict()
        for w in d["per_worker"].values():
            # host seconds of the engine's phases: no two runs share them
            del w["engine"]["phases"]
        runs.append(({rec.req.rid: rec.req.out_tokens for rec in fleet.completed}, d))
    np.testing.assert_equal(runs[1], runs[0])        # nested, NaN equal to NaN


@pytest.mark.cuda
@pytest.mark.parametrize("arch,strategy,mesh_shape", [
    ("whisper-small", "gspmd_tp", (1, 1)), ("llama4-scout-17b-a16e", "gspmd_tp", (1, 1)),
    ("grok-1-314b", "gspmd_pp", (4, 1)), ("granite-8b", "gspmd_pp", (4, 1))])
def test_gspmd_steps_on_the_card_match_the_cpu(cuda_device, arch, strategy, mesh_shape, capsys):
    """fp32: a GSPMD train step (gspmd_tp at grad_accum 2, gspmd_pp over 4
    emulated stages) on reduced configs gives the CPU step's loss and
    gradient norm; flash and RMSNorm launch; the step is timed by CUDA events
    (median of 5, printed with ``-s``)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import RunConfig, ShapeConfig, get_config, reduced_config
    from repro_torch.convert import move_params, tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=8)
    seq = 64 if cfg.attention == "chunked_local" else 32
    rcfg = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                     strategy=strategy, grad_accum=2 if strategy == "gspmd_tp" else 1,
                     microbatches=4 if strategy == "gspmd_pp" else 0)
    shape = ShapeConfig("t", seq, 8, "train")
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="const", weight_decay=0.0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, seq), dtype=np.int32))}
    if cfg.n_enc_layers:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((8, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    p0 = build_model(cfg, rcfg, device="cpu").init(0)
    out = {}
    for dev in ("cpu", cuda_device):
        built = make_train_step(cfg, shape, rcfg, make_host_mesh(mesh_shape), opt_cfg,
                                device=dev)
        p = built.get("to_pipeline", lambda t: t)(tree_map(lambda t: t.clone().to(dev), p0))
        b = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launch_counts()
        _, _, met = built["fn"](p, adamw.init(p), b)
        out[str(dev)] = (met["loss"].item(), met["grad_norm"].item(), ops.launch_counts())
    loss_c, norm_c, _ = out["cpu"]
    loss_g, norm_g, counts = out[str(cuda_device)]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    assert abs(norm_g - norm_c) <= 1e-5 * norm_c
    assert counts["flash_attention"] > 0 and counts["rmsnorm"] > 0
    p = built.get("to_pipeline", lambda t: t)(move_params(p0, cuda_device))
    o = adamw.init(p)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p, o, _ = built["fn"](p, o, b)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with capsys.disabled():
        print(f"\n[gspmd] {arch} {strategy} reduced, 8 layers, fp32, 8 x {seq}: step "
              f"{float(np.median(times)):.2f} ms (median of 5, CUDA events); {built['meta']}")
