"""The other families in the port against the JAX package: the registry, the
serving gates of every LM, the dense configs that need no new code
(command-r-35b, mistral-nemo-12b, yi-34b), the pure-SSM family (it has no
config in the registry) and the launchers over every arch.

Reduced configs (``reduced_config``), fp32, weights from the JAX init
through ``params_from_jax``, inputs from seeded numpy generators.
Tolerances: logits 1e-5 (attention families; the recurrent pure SSM 1e-4 x
max(1, |ref|), its prefill runs the chunked scan where the reference runs
the token recurrence, as in ``test_torch_recurrent_engine.py``), losses
1e-5 relative, gradients 1e-4 x max(1, max|g|), greedy tokens identical.
``tests/test_torch_moe.py``, ``test_torch_encdec.py`` and
``test_torch_vlm.py`` import the helpers below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, RunConfig, get_config, reduced_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import FrontendPipeline as JFrontendPipeline
from repro.models.api import build_model
from repro.models.api import stage_eligible as jeligible
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.configs as tconfigs
from repro_torch.convert import leaves, params_from_jax
from repro_torch.data.synthetic import DataConfig, FrontendPipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.models.api import stage_eligible
from repro_torch.serving.engine import EngineConfig, ServeEngine

LOGIT_TOL = 1e-5
RECURRENT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
MAX_LEN = 48
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
DENSE_CONFIGS = ("command-r-35b", "mistral-nemo-12b", "yi-34b")


def pure_ssm(cfg):
    """The pure-SSM family (Mamba2 layers, no shared block) on zamba2's
    reduced widths: no config of the registry has it."""
    return dataclasses.replace(cfg, arch_id="mamba2-smoke", family="ssm", attn_every=0)


def models(arch, n_layers=2, seed=0, edit=None, remat=False):
    """(jax model, jax params, port model, port params) of a reduced arch,
    ``edit`` applied to both configs; the port's params are the JAX init's."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                               n_layers=n_layers)
    if edit is not None:
        cfg, tcfg = edit(cfg), edit(tcfg)
    model = build_model(cfg, RunConfig(**F32))
    params = model.init(jax.random.key(seed))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(**{**F32, "remat": remat}), device="cpu")
    return model, params, tmodel, params_from_jax(np_tree(params), device="cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(port: torch.Tensor, ref) -> float:
    """max |port - ref| / max(1, max |ref|)."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.detach().float().numpy() - ref).max()) / max(
        1.0, float(np.abs(ref).max()))


def tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def extras(cfg, b, seed=0):
    """A family's per-sequence model inputs beside the tokens, numpy (B, ...):
    whisper's frames, internvl2's frontend rows, as ``FrontendPipeline``
    draws them."""
    if cfg.family == "audio":
        key = "frames"
    elif cfg.frontend:
        key = "frontend"
    else:
        return {}
    pipe = FrontendPipeline(DataConfig(cfg.vocab_size, 2, b, seed), cfg.frontend_seq,
                            cfg.d_model, key=key)
    return {key: pipe.batch(0)[key]}


def check_prefill_decode(model, params, tmodel, tparams, batch, steps=4, tol=LOGIT_TOL):
    """Prefill ``batch`` (numpy) in both packages, then ``steps`` greedy
    decode steps: logits within ``tol`` (relative to max(1, |ref|)) and the
    same argmax at every step.  Returns the two final caches."""
    lj, cj = model.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, MAX_LEN)
    lt, ct = tmodel.prefill(tparams, {k: torch.as_tensor(v) for k, v in batch.items()},
                            MAX_LEN)
    v = model.cfg.vocab_size
    assert rel(lt, lj) < tol
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(lj[:, :v], -1)).astype(np.int32)[:, None]
        assert np.array_equal(torch.argmax(lt[:, :v], -1).numpy(), nxt[:, 0])
        lj, cj = model.decode_step(params, cj, jnp.asarray(nxt))
        lt, ct = tmodel.decode_step(tparams, ct, torch.as_tensor(nxt).long())
        assert rel(lt, lj) < tol
    return ct, cj


def serve(engine_cls, model, params, prompts, inputs=None, max_new=4, max_batch=2, **kw):
    """Greedy tokens of ``prompts`` (with per-request ``inputs``) by rid."""
    eng = engine_cls(model, params, max_batch=max_batch, max_len=MAX_LEN, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, **(inputs[i] if inputs else {}))
    return {r.rid: list(r.out_tokens) for r in eng.run_until_drained()}, eng


def check_loss_and_grads(model, params, tmodel, tparams, batch):
    """The loss, its ce and aux, and every gradient leaf."""
    (loss, aux), grads = jax.value_and_grad(
        lambda p: model.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    flat = list(leaves(tparams))
    for p in flat:
        p.requires_grad_(True)
    tloss, taux = tmodel.loss(tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, flat)
    for p in flat:
        p.requires_grad_(False)
    assert abs(tloss.item() - float(loss)) <= LOSS_TOL * abs(float(loss))
    assert abs(taux["ce"].item() - float(aux["ce"])) <= LOSS_TOL * abs(float(aux["ce"]))
    assert abs(taux["aux"].item() - float(aux["aux"])) <= LOSS_TOL * max(1.0, abs(float(
        aux["aux"])))
    jflat = list(leaves(params_from_jax(np_tree(grads), device="cpu")))
    assert len(jflat) == len(tgrads)
    for i, (a, ref) in enumerate(zip(tgrads, jflat)):
        assert rel(a, ref.numpy()) < GRAD_TOL, i
    return tloss, taux


# --- the registry and the gates -----------------------------------------------

def test_registry_is_the_references():
    assert tconfigs.ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        full = get_config(arch)
        assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(full)
        assert dataclasses.asdict(tconfigs.reduced_config(tconfigs.get_config(arch))) == \
            dataclasses.asdict(reduced_config(full))


@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["pure-ssm"])
def test_serving_gates_are_the_references(arch):
    """``batched_prefill`` (the reference's ragged_ok), the block pool
    (pool_ok), the state kind, the window step and stage eligibility, for
    every LM of the registry and the pure-SSM family."""
    edit = pure_ssm if arch == "pure-ssm" else None
    name = "zamba2-7b" if arch == "pure-ssm" else arch
    cfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if edit is not None:
        cfg, tcfg = edit(cfg), edit(tcfg)
    ds = build_model(cfg, RunConfig(**F32)).decode_state
    tds = tbuild_model(tcfg, tconfigs.RunConfig(**F32), device="cpu").decode_state
    assert tds.kind == ds.kind
    assert (tds.batched_prefill is None) == (ds.batched_prefill is None)
    assert tds.poolable == ds.poolable
    assert (tds.pool_window_step is None) == (ds.pool_window_step is None)
    assert tds.window_step is not None and ds.window_step is not None
    assert stage_eligible(tcfg) == jeligible(cfg)


def test_batched_prefill_gate_excludes_unsafe_families():
    """``tests/test_serving.py``'s case on the port: right-padded batched
    prefill only where padding is provably inert (dense full attention)."""
    rc = tconfigs.RunConfig(**F32)
    get = lambda a: tbuild_model(tconfigs.reduced_config(tconfigs.get_config(a)), rc,
                                 device="cpu")
    assert get("granite-8b").decode_state.batched_prefill is not None
    for arch in ("grok-1-314b", "llama4-scout-17b-a16e", "rwkv6-1.6b", "zamba2-7b",
                 "whisper-small", "internvl2-1b"):
        assert get(arch).decode_state.batched_prefill is None, arch
    assert get("grok-1-314b").decode_state.poolable
    assert not get("llama4-scout-17b-a16e").decode_state.poolable
    assert get("whisper-small").decode_state.kind == "encdec"


# --- the dense configs ---------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_CONFIGS)
def test_dense_configs_match_jax(arch):
    """Prefill and decode logits, then greedy tokens over bucketed dense
    lanes and over the paged pool, each equal to the JAX engine's."""
    model, params, tmodel, tparams = models(arch)
    check_prefill_decode(model, params, tmodel, tparams, {"tokens": tokens(0, (2, 20))})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=5 + 3 * i) for i in range(4)]
    ref, _ = serve(JaxEngine, model, params, prompts)
    port, _ = serve(ServeEngine, tmodel, tparams, prompts)
    assert port == ref
    paged = dict(config=EngineConfig(kv_blocks=24, kv_block_size=8))
    port_paged, eng = serve(ServeEngine, tmodel, tparams, prompts, **paged)
    ref_paged, _ = serve(JaxEngine, model, params, prompts,
                         config=JaxEngineConfig(kv_blocks=24, kv_block_size=8))
    assert eng.backend.name == "paged" and port_paged == ref_paged == ref


def test_mistral_nemo_q_dim_differs_from_d_model():
    """mistral-nemo-12b's q_dim (4096) is not its d_model (5120); the reduced
    config keeps head_dim x heads = d_model, so a width edit holds the
    projection shapes and the loss to JAX at q_dim != d_model."""
    full = tconfigs.get_config("mistral-nemo-12b")
    assert full.q_dim == 4096 and full.d_model == 5120
    edit = lambda c: dataclasses.replace(c, head_dim=24)          # q_dim 96 != 128
    model, params, tmodel, tparams = models("mistral-nemo-12b", edit=edit)
    assert tmodel.cfg.q_dim == 96 and tuple(tparams["blocks"][0]["attn"]["wo"].shape) == (96, 128)
    check_prefill_decode(model, params, tmodel, tparams, {"tokens": tokens(2, (2, 12))})
    check_loss_and_grads(model, params, tmodel, tparams, {"tokens": tokens(3, (2, 24))})


# --- the pure-SSM family -------------------------------------------------------

def test_pure_ssm_family_matches_jax():
    """Mamba2 layers alone: prefill and decode logits, the loss and every
    gradient, and greedy tokens over the recurrent backend against the JAX
    engine's."""
    model, params, tmodel, tparams = models("zamba2-7b", edit=pure_ssm, seed=2)
    assert "shared" not in tparams and tmodel.decode_state.kind == "recurrent"
    ct, cj = check_prefill_decode(model, params, tmodel, tparams,
                                  {"tokens": tokens(4, (2, 20))}, tol=RECURRENT_TOL)
    assert set(ct["layers"]) == {"conv", "ssm"} and "ak" not in ct
    assert rel(ct["layers"]["ssm"], cj["layers"]["ssm"]) < RECURRENT_TOL
    check_loss_and_grads(model, params, tmodel, tparams, {"tokens": tokens(5, (2, 32))})
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=4 + 5 * i) for i in range(4)]
    port, eng = serve(ServeEngine, tmodel, tparams, prompts)
    ref, _ = serve(JaxEngine, model, params, prompts)
    assert eng.backend.name == "recurrent" and port == ref


# --- the launchers -------------------------------------------------------------

def test_frontend_pipeline_is_the_references():
    for key in ("frontend", "frames"):
        args = (5, 7, 16)
        ref = JFrontendPipeline(JDataConfig(*args, seed=3), 6, 8, key=key, shard=1,
                                n_shards=2).batch(4)
        got = FrontendPipeline(DataConfig(*args, seed=3), 6, 8, key=key, shard=1,
                               n_shards=2).batch(4)
        assert sorted(got) == sorted(ref) == sorted(["tokens", key])
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b", "llama4-scout-17b-a16e",
                                  "grok-1-314b", "command-r-35b"])
def test_launchers_take_every_arch(arch, tmp_path, capsys):
    """Both launchers list every arch id of the registry; serve drives the
    engine and train runs two steps (whisper on frames, internvl2 on
    frontend rows)."""
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "3",
                 "--layers", "1", "--max-len", "64"])
    assert "3 requests, 9 tokens" in capsys.readouterr().out
    out = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "24", "--layers", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
