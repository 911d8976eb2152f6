"""The port's training path against the JAX package's, on the CPU, in fp32.

Weights come from the JAX init through ``params_from_jax``; batches from
the same ``TokenPipeline`` seed.  Tolerances: loss within 1e-5 relative,
each gradient leaf within 1e-4 x max(1, max|g|), one AdamW update within
1e-6, a 5-step loss trajectory within 1e-4 (fp32 in both frameworks, which
sum in different orders).  Checkpoints and codec frames must cross between
the packages bit for bit.
"""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import RunConfig, get_config, reduced_config
from repro.data.synthetic import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline
from repro.models.api import build_model
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.wire import codec as jcodec
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import store as tstore
from repro_torch.convert import leaves, params_from_jax, tensor_from_numpy, tree_map
from repro_torch.data.synthetic import DataConfig, TokenPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models.api import build_model as tbuild_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.wire import codec

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAMW_TOL = 1e-6
TRAJ_TOL = 1e-4
ARCHS = ("rwkv6-1.6b", "granite-8b", "zamba2-7b")


def _pair(arch, n_layers, uk, remat=False):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)),
                               n_layers=n_layers)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32",
                                       remat=False, use_kernels=uk))
    tmodel = tbuild_model(tcfg, tconfigs.RunConfig(param_dtype="float32",
                                                   compute_dtype="float32", remat=remat),
                          device="cpu")
    return model, tmodel


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _max_rel(a: torch.Tensor, ref: np.ndarray) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a.detach().float().numpy() - ref).max()) / max(1.0, float(
        np.abs(ref).max()))


@pytest.mark.parametrize("uk", [False, True], ids=["jax-plain", "jax-kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, uk):
    """lm_loss and every gradient leaf; the port checkpoints its blocks
    (remat) in the kernels case, so both of its paths are held."""
    model, tmodel = _pair(arch, 2, uk, remat=uk)
    params = model.init(jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 48)).astype(np.int32)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True)(params)
    tparams = params_from_jax(_np_tree(params), device="cpu")
    flat = list(leaves(tparams))
    for p in flat:
        p.requires_grad_(True)
    tloss, taux = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks)})
    tgrads = torch.autograd.grad(tloss, flat)
    assert abs(tloss.item() - float(loss)) <= LOSS_TOL * abs(float(loss))
    assert float(taux["aux"]) == float(aux["aux"]) == 0.0
    jflat = list(leaves(params_from_jax(_np_tree(grads), device="cpu")))
    assert len(jflat) == len(tgrads)
    for i, (a, ref) in enumerate(zip(tgrads, jflat)):
        assert _max_rel(a, ref.numpy()) < GRAD_TOL, i


def test_remat_changes_nothing_in_the_port():
    _, plain = _pair("rwkv6-1.6b", 2, False, remat=False)
    _, remat = _pair("rwkv6-1.6b", 2, False, remat=True)
    params = plain.init(3)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 512, size=(2, 24)))
    out = []
    for m in (plain, remat):
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
        loss, _ = m.loss(params, {"tokens": toks})
        out.append((loss, torch.autograd.grad(loss, flat)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _opt_tree(rng):
    """A small param tree with 1-D (no decay) and 2-D leaves, fp32 and bf16."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "blocks": [{"s": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)}]}


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_adamw_update_matches_jax(schedule):
    """Three updates (warmup, bias correction, clipping: gradients scaled
    to a global norm above clip_norm) on the same params and gradients."""
    cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5, weight_decay=0.1,
                             schedule=schedule)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(2)
    p = _opt_tree(rng)
    jp, jopt = jax.tree.map(jnp.asarray, p), jadamw.init(jax.tree.map(jnp.asarray, p))
    tp = tree_map(tensor_from_numpy, p)
    topt = adamw.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: (3.0 * rng.standard_normal(a.shape)).astype(a.dtype), p)
        jp, jopt, jst = jadamw.update(cfg, jax.tree.map(jnp.asarray, g), jopt, jp)
        tp, topt, tst = adamw.update(tcfg, tree_map(tensor_from_numpy, g), topt, tp)
        assert float(tst["lr"]) == pytest.approx(float(jst["lr"]), rel=ADAMW_TOL)
        assert float(tst["grad_norm"]) == pytest.approx(float(jst["grad_norm"]), rel=ADAMW_TOL)
        for a, ref in zip(leaves([tp, topt["m"], topt["v"]]),
                          jax.tree.leaves([jp, jopt["m"], jopt["v"]])):
            ref = np.asarray(ref, np.float32)
            assert np.abs(a.float().numpy() - ref).max() <= ADAMW_TOL * max(
                1.0, np.abs(ref).max())
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
    for s in range(8):
        assert float(adamw.lr_at(tcfg, torch.tensor(s))) == pytest.approx(
            float(jadamw.lr_at(cfg, jnp.int32(s))), rel=ADAMW_TOL)


def test_token_pipeline_is_the_references():
    for seed, shard, n in ((0, 0, 1), (3, 1, 2)):
        cfg = dict(vocab_size=512, seq_len=33, global_batch=4, seed=seed)
        a = TokenPipeline(DataConfig(**cfg), shard, n)
        b = JTokenPipeline(JDataConfig(**cfg), shard, n)
        for step in (0, 1, 7):
            assert np.array_equal(a.batch(step)["tokens"], b.batch(step)["tokens"])


class _Clock:
    """Advances 0.25 s on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


# zamba2 at the launcher's own batch (8 x 128): at 4 x 32 its loss (the
# reference's and the port's alike) does not fall within 5 warm-up steps
@pytest.mark.parametrize("arch,batch,seq", [("rwkv6-1.6b", 4, 32), ("zamba2-7b", 8, 128)])
def test_trainer_trajectory_matches_jax_launcher_step(tmp_path, arch, batch, seq):
    """5 steps of the port's launcher step through its Trainer against the
    JAX launcher's step (value_and_grad + adamw.update, jitted) through the
    JAX Trainer, on the same TokenPipeline batches and weights."""
    model, tmodel = _pair(arch, 2, False)
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=5, weight_decay=0.01)
    pipe = JTokenPipeline(JDataConfig(vocab_size=512, seq_len=seq, global_batch=batch))
    params = model.init(jax.random.key(0))

    @jax.jit
    def jstep(p, opt, batch):
        (loss, _), g = jax.value_and_grad(lambda p, b: model.loss(p, b), has_aux=True)(p, batch)
        p2, o2, st = jadamw.update(opt_cfg, g, opt, p)
        return p2, o2, dict(loss=loss, **st)

    def jdata(start):
        s = start
        while True:
            yield {k: jnp.asarray(v) for k, v in pipe.batch(s).items()}
            s += 1

    jout = JTrainer(JTrainerConfig(total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path / "j")),
                    jstep, lambda: (params, jadamw.init(params)), jdata).run()

    tparams = params_from_jax(_np_tree(params), device="cpu")
    tpipe = TokenPipeline(DataConfig(vocab_size=512, seq_len=seq, global_batch=batch))
    tr = Trainer(TrainerConfig(total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path / "t")),
                 tlaunch.make_step_fn(tmodel, adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))),
                 lambda: (tparams, adamw.init(tparams)),
                 lambda start: tlaunch.token_batches(tpipe, start, "cpu"), clock=_Clock())
    tout = tr.run()
    assert len(tout["losses"]) == len(jout["losses"]) == 5
    assert np.abs(np.array(tout["losses"]) - np.array(jout["losses"])).max() < TRAJ_TOL
    assert tout["losses"][-1] < tout["losses"][0]
    assert [r["step_s"] for r in tout["history"]] == [0.25] * 5


def test_zamba2_serving_entry_points_name_recurrent_serving():
    """zamba2 trains and serves, as rwkv6: its decode state is recurrent
    (no pool, no batched prefill), and its prefill, decode step and cache
    give the Mamba2 state and the shared block's K/V slots
    (tests/test_torch_recurrent_engine.py holds them to the reference)."""
    model, tmodel = _pair("zamba2-7b", 2, False)
    ds = tmodel.decode_state
    assert ds.kind == "recurrent" and not ds.poolable and ds.batched_prefill is None
    toks = torch.zeros((1, 4), dtype=torch.long)
    tp = tmodel.init(0)
    with torch.no_grad():
        _, cache = tmodel.prefill(tp, {"tokens": toks}, 8)
        logits, cache = tmodel.decode_step(tp, cache, toks[:, :1])
    assert logits.shape == (1, 512) and torch.isfinite(logits).all()
    assert cache["pos"].tolist() == [5]
    empty = tmodel.init_cache(1, 8)
    assert sorted(empty) == ["ak", "av", "layers", "pos"]
    assert empty["ak"].shape == cache["ak"].shape == (1, 1, 8, 4, 32)   # one firing, 2 layers
    written = cache["ak"][0, 0].abs().amax(dim=(1, 2))
    assert bool((written[:5] > 0).all()) and float(written[5:].max()) == 0.0


def test_params_from_jax_carries_the_shared_block():
    """The reduced zamba2 tree: ``shared`` crosses whole (one set of
    weights, not stacked) beside the per-layer ``blocks``, bit-equal, in
    the port's own init structure; A_log, D and dt_bias stay fp32 in a bf16
    tree."""
    cfg = reduced_config(get_config("zamba2-7b"))
    model = build_model(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16"))
    params = _np_tree(model.init(jax.random.key(1)))
    tparams = params_from_jax(params, device="cpu")
    own = tbuild_model(tconfigs.reduced_config(tconfigs.get_config("zamba2-7b")),
                       tconfigs.RunConfig(), device="cpu").init(0)
    assert sorted(tparams) == sorted(own) == ["blocks", "embed", "final_ln", "shared"]
    assert len(tparams["blocks"]) == cfg.n_layers
    shape = lambda tree: tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert shape(tparams) == shape(own)
    assert tparams["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    assert tparams["shared"]["attn"]["wq"].dtype == torch.bfloat16
    jflat = [np.asarray(a).view(np.uint16) if a.dtype.name == "bfloat16" else np.asarray(a)
             for a in jax.tree.leaves(params["shared"])]
    for a, ref in zip(leaves(tparams["shared"]), jflat):
        got = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
        assert np.array_equal(got, ref)


def test_trainer_restarts_and_resumes_from_its_checkpoint(tmp_path):
    """A worker failure at step 3 restores the step-2 checkpoint and
    replays to the same losses as an uninterrupted run."""
    from repro_torch.runtime.faults import FaultPlan
    _, tmodel = _pair("granite-8b", 1, False)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    pipe = TokenPipeline(DataConfig(vocab_size=512, seq_len=16, global_batch=2))

    def run(d, plan=None):
        init = lambda: (lambda p: (p, adamw.init(p)))(tmodel.init(0))
        tr = Trainer(TrainerConfig(total_steps=5, ckpt_every=2, ckpt_dir=str(tmp_path / d)),
                     tlaunch.make_step_fn(tmodel, opt_cfg), init,
                     lambda start: tlaunch.token_batches(pipe, start, "cpu"), fault_plan=plan)
        return tr, tr.run()

    _, clean = run("clean")
    tr, failed = run("failed", FaultPlan(fail_at={3: "worker0"}))
    assert tr.restarts == 1
    assert failed["losses"] == clean["losses"][2:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(failed["params"]),
                                                 leaves(clean["params"])))


def _state_tree():
    """A trainer-like state: bf16 and fp32 leaves, a layer list, an int32 step."""
    rng = np.random.default_rng(5)
    return {"params": {"embed": {"tok": rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16)},
                       "blocks": [{"w": rng.standard_normal((4, 4)).astype(np.float32)}
                                  for _ in range(2)]},
            "opt": {"step": np.int32(7), "m": [rng.standard_normal(3).astype(np.float32)]}}


def _same_bits(t: torch.Tensor, ref: np.ndarray) -> bool:
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    return np.array_equal(t.numpy(), np.asarray(ref)) and str(t.dtype).removeprefix(
        "torch.") == str(np.asarray(ref).dtype)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = _state_tree()
    jstore.save(tmp_path, 7, tree, extra={"next_step": 7})
    like = tree_map(lambda a: torch.zeros(np.shape(a), dtype=tensor_from_numpy(
        np.asarray(a)).dtype), tree)
    got, extra = tstore.restore(tmp_path, like=like)
    assert extra == {"next_step": 7} and tstore.latest_step(tmp_path) == 7
    for a, ref in zip(leaves(got), jax.tree.leaves(tree)):
        assert _same_bits(a, ref)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    tree = tree_map(lambda a: tensor_from_numpy(np.asarray(a)), _state_tree())
    ck = tstore.AsyncCheckpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save_async(step, tree, extra={"next_step": step})
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    like = _state_tree()
    got, extra = jstore.restore(tmp_path, like=like)
    assert extra == {"next_step": 3}
    for a, ref in zip(leaves(tree), jax.tree.leaves(got)):
        assert _same_bits(a, ref)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["leaves"]["params/embed/tok"] == {"shape": [8, 4], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt/step"] == {"shape": [], "dtype": "int32"}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, np.int8, np.int16,
                                   np.int32, np.int64, np.uint8, np.uint16, np.bool_,
                                   ml_dtypes.bfloat16])
def test_codec_frames_cross_between_the_packages(dtype):
    a = (np.random.default_rng(0).standard_normal((3, 5)) * 50).astype(dtype)
    for arr in (a, a[0, 0].reshape(()), a[:0]):
        jbuf, tbuf = io.BytesIO(), io.BytesIO()
        jcodec.encode_tensor(arr, jbuf)
        codec.encode_tensor(tensor_from_numpy(arr) if dtype is not np.uint16 else arr, tbuf)
        assert jbuf.getvalue() == tbuf.getvalue()
        back = codec.decode_tensor(io.BytesIO(jbuf.getvalue()))
        assert tuple(back.shape) == arr.shape and _same_bits(back, arr)
        jback = jcodec.decode_tensor(io.BytesIO(tbuf.getvalue()))
        assert jback.shape == arr.shape and jback.dtype == arr.dtype
        assert np.array_equal(jback.reshape(-1).view(np.uint8), arr.reshape(-1).view(np.uint8))


def test_codec_pytrees_cross_between_the_packages():
    tree = {"b": [np.arange(3, dtype=np.int32), (None, np.float32(2.5))],
            "a": {"z": np.ones((2, 2), ml_dtypes.bfloat16), "y": np.zeros((0,), np.float32)}}
    data = jcodec.dumps(tree)
    back = codec.loads(data)
    assert codec.dumps(back) == data
    assert back["b"][1][0] is None and isinstance(back["b"][1], tuple)
    with pytest.raises(codec.WireError, match="CRC"):
        codec.loads(data[:-1] + bytes([data[-1] ^ 1]))
