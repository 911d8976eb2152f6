"""The comparison that decides ``correct`` fails what it must: a run with
the timed path broken underneath (the check for a card skipped, the rest
of the run driven as on the card, tiny and on the CPU) comes out not
correct for each fault its cell can have, and the float8 control, put in
the program's place, comes out not correct."""

import dataclasses

import pytest
import torch

from harness import runner
from tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 101


def run(cell, **kw):
    return runner.run_cell(cell, SEED, 2.0, False, CPU, 0.0, **kw)


@pytest.mark.parametrize("name", ["granite-8b.batch", "granite-8b.docqa", "rwkv6-1.6b.train"])
def test_sound_run_is_correct(name):
    out = run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", ["granite-8b.batch", "granite-8b.docqa"])
def test_served_token_altered(name, monkeypatch):
    from repro_torch.serving import sampling
    inner = sampling.Sampler.sample

    def altered(self, logits, *a, **kw):
        return (inner(self, logits, *a, **kw) + 1) % 512
    monkeypatch.setattr(sampling.Sampler, "sample", altered)
    out = run(tiny_cell(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["granite-8b.batch", "granite-8b.docqa"])
def test_decode_step_leaves_its_state_unchanged(name, monkeypatch):
    from repro_torch.serving import backends
    for cls in (backends.DenseBackend, backends.PagedBackend):
        inner = cls.step

        def frozen(self, params, tokens, active, inner=inner):
            pos = self.cache["pos"].clone()
            k = self.cache["layers"]["k"].clone()
            v = self.cache["layers"]["v"].clone()
            out = inner(self, params, tokens, active)
            self.cache["pos"].copy_(pos)
            self.cache["layers"]["k"].copy_(k)
            self.cache["layers"]["v"].copy_(v)
            return out
        monkeypatch.setattr(cls, "step", frozen)
    out = run(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_training_step_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(cfg, grads, opt_state, params):
        return params, opt_state, {"grad_norm": adamw.global_norm(grads),
                                   "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "update", unchanged)
    out = run(tiny_cell("rwkv6-1.6b.train"))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_left_out():
    out = run(tiny_cell("rwkv6-1.6b.train"),
              hooks={"batch": lambda t: t[: t.shape[0] // 2]})
    assert not out["correct"], out["checks"]


def _wider(cell, **model):
    config = {**cell.config, "model": {**cell.config["model"], **model}}
    return dataclasses.replace(cell, config=config)


def test_served_control_fails_the_limit():
    """The float8 reference's first choice at every served position of the
    program's own prompts and tokens, judged as the program's tokens are."""
    cell = _wider(tiny_cell("granite-8b.batch"), d_model=256, n_heads=8, n_kv_heads=2,
                  head_dim=32, d_ff=768, n_layers=8, vocab_size=4096)
    check = {"served_tokens": 160, "requests": 4}
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "check": check})
    out = run(cell, fp8=True)
    limit = cell.limits["numbers"]["logit_gap"]["limit"]
    assert out["numbers"]["logit_gap"] <= limit, out["numbers"]
    assert not out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] == out["numbers"]["control_logit_gap"]


def test_training_control_separates():
    """At a size the CPU holds the float8 control reads its gradients at 3x
    the program's gap or more; its reading against the cell's own limits
    is taken at the cell's size on the card (``test_perfbench_card.py``)."""
    cell = _wider(tiny_cell("rwkv6-1.6b.train"), d_model=256, n_heads=4, n_kv_heads=4,
                  head_dim=64, d_ff=896, n_layers=4, vocab_size=2048)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "batch": 4, "seq": 64})
    out = run(cell, fp8=True)["numbers"]
    assert out["control_grad_gap"] >= 3 * out["grad_gap"], out
