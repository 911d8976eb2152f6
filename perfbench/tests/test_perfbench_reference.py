"""The plain references agree with the program at a small size on the CPU
in fp32 (logits, loss, every gradient leaf), and the chunked WKV of the
reference with its own token recurrence."""

import pytest
import torch

from reference import common, dense, rwkv6
from tiny import tiny_cell


def fp32(node):
    if isinstance(node, dict):
        return {k: fp32(v) for k, v in node.items()}
    if isinstance(node, list):
        return [fp32(v) for v in node]
    return node.float()


def port(cell):
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.models.api import build_model
    rc = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False)
    return build_model(ModelConfig(**cell.config["model"]), rc, device="cpu")


def paths(node, pre=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from paths(v, pre + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from paths(v, pre + (i,))
    else:
        yield pre, tuple(node.shape), node.dtype


@pytest.mark.parametrize("name,ref", [("granite-8b.batch", dense), ("rwkv6-1.6b.train", rwkv6)])
def test_tree_is_the_programs(name, ref):
    cell = tiny_cell(name)
    m = cell.config["model"]
    ours = common.tree(common.draw(ref.param_specs(m), 3, "cpu"))
    from repro_torch.models.api import build_model
    from repro_torch.configs.base import ModelConfig, RunConfig
    theirs = build_model(ModelConfig(**m), RunConfig(), device="cpu").init(0)
    assert sorted(map(str, paths(ours))) == sorted(map(str, paths(theirs)))


def test_dense_logits_match_the_program():
    cell = tiny_cell("granite-8b.batch")
    m = cell.config["model"]
    params = fp32(common.tree(common.draw(dense.param_specs(m), 4, "cpu")))
    toks = torch.randint(0, m["vocab_size"], (2, 29), generator=torch.Generator().manual_seed(0))
    model = port(cell)
    for row in toks:
        got, _ = model.prefill(params, {"tokens": row[None]}, 64)
        want = dense.logits_at(m, params, [row], [torch.tensor([28])])[0]
        torch.testing.assert_close(got[0, :m["vocab_size"]], want[0], atol=2e-5, rtol=1e-5)


def test_rwkv6_loss_and_gradients_match_the_program():
    cell = tiny_cell("rwkv6-1.6b.train")
    m = cell.config["model"]
    flat = {k: v.float() for k, v in common.draw(rwkv6.param_specs(m), 5, "cpu").items()}
    toks = torch.randint(0, m["vocab_size"], (2, 45), generator=torch.Generator().manual_seed(1))
    model = port(cell)
    tree = common.tree({k: v.clone().requires_grad_(True) for k, v in flat.items()})
    got, _ = model.loss(tree, {"tokens": toks})
    leaves = dict((p, t) for p, t in _leaf_items(tree))
    g_got = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    ours = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    want = rwkv6.loss(m, ours, toks)
    g_want = dict(zip(ours, torch.autograd.grad(want, list(ours.values()))))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for k in ours:
        torch.testing.assert_close(g_got[k], g_want[k], atol=1e-6, rtol=1e-4)


def _leaf_items(node, pre=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaf_items(v, pre + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaf_items(v, pre + (i,))
    else:
        yield pre, node


def test_chunked_wkv_is_the_token_recurrence():
    g = torch.Generator().manual_seed(2)
    b, t, h, k = 2, 37, 3, 8
    f64 = dict(generator=g, dtype=torch.float64)
    r, kk, v = (torch.randn(b, t, h, k, **f64) for _ in range(3))
    logw = -torch.exp(torch.randn(b, t, h, k, **f64) * 2 - 1)      # strong decay too
    u = torch.randn(h, k, **f64)
    state = torch.zeros(b, h, k, k, dtype=torch.float64)
    outs = []
    for i in range(t):
        kv = kk[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, i], state + u[None, :, :, None] * kv))
        state = torch.exp(logw[:, i])[..., None] * state + kv
    torch.testing.assert_close(rwkv6.wkv(r, kk, v, logw, u), torch.stack(outs, 1),
                               atol=1e-12, rtol=1e-12)


def test_adamw_matches_the_programs_update():
    from repro_torch.optim import adamw
    opt = tiny_cell("rwkv6-1.6b.train").config["optimizer"]
    g = torch.Generator().manual_seed(3)
    p = {("a",): torch.randn(6, 5, generator=g), ("b",): torch.randn(5, generator=g)}
    theirs = {"a": p[("a",)].clone(), "b": p[("b",)].clone()}
    state = adamw.init(theirs)
    ours = {k: v.clone() for k, v in p.items()}
    mine = common.AdamW(opt, ours)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in p.items()}
        theirs, state, _ = adamw.update(adamw.AdamWConfig(**opt),
                                        {"a": grads[("a",)], "b": grads[("b",)]}, state, theirs)
        mine.update(ours, grads)
    torch.testing.assert_close(ours[("a",)], theirs["a"], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ours[("b",)], theirs["b"], atol=1e-6, rtol=1e-6)
