"""The counters reproduce the bound column of PERF.md's kernel table at
its shapes (ms, H100: 989 TFLOP/s bf16, 3.35 TB/s)."""

import pytest

from harness import yardstick as ys

CASES = [
    # flash B=2 T=1024 H=32 G=8 D=128 causal: 0.0174 (operations)
    (lambda: ys.flash_call(2, 1024, 32, 8, 128), 0.0174, "operations"),
    # zamba2's flash B=8 T=512 H=32 G=32 D=112: 0.0351 (bytes)
    (lambda: ys.flash_call(8, 512, 32, 32, 112), 0.0351, "bytes"),
    # the serving bucket B=8 T=128: 0.0063 (bytes)
    (lambda: ys.flash_call(8, 128, 32, 8, 128), 0.0063, "bytes"),
    # decode B=8 S=1024 H=32 G=8 D=128, 3020 live: 0.0037 (bytes)
    (lambda: ys.decode_call(8, 3020, 32, 8, 128, 1024), 0.0037, "bytes"),
    # WKV6 B=8 T=512 H=32 K=64: 0.0301 (bytes)
    (lambda: ys.rwkv6_call(8, 512, 32, 64), 0.0301, "bytes"),
]


@pytest.mark.parametrize("case,ms,by", CASES)
def test_bound_column(case, ms, by):
    flops, nbytes = case()
    t, what = ys.bound(flops, ys.PEAK_BF16_FLOPS, nbytes)
    assert round(t * 1e3, 4) == ms and what == by


def test_flash_pairs_closed_form_matches_the_mask():
    assert ys.flash_pairs(37, 37, True) == sum(range(1, 38))
    assert ys.flash_pairs(40, 40, True, chunk=16) == 16 * 17 // 2 * 2 + 8 * 9 // 2


def test_merged_length():
    assert ys.merged_length([(0, 10), (5, 15), (20, 25)]) == 20


def test_serve_flops_counts_each_token_once():
    from harness.readers import dense_params, serve_flops
    m = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16, vocab_size=32)
    layers, head = dense_params(m, head=False), dense_params(m) - dense_params(m, head=False)
    per_pair = 4.0 * 2 * 4 * 2
    p, g = 5, 3
    want = 2 * layers * p + 2 * head + per_pair * sum(range(1, p + 1))   # prefill, first token
    want += sum(2 * (layers + head) + per_pair * (p + j + 1) for j in range(g - 1))
    assert serve_flops(m, p, g) == want
    assert dense_params(m, head=False) == 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
