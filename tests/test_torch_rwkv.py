"""The port's rwkv6 pieces against the JAX package, same inputs, fp32.

Inputs come from seeded numpy generators and go to both packages; the JAX
rwkv6 kernel runs in interpret mode (its custom VJP differentiates the
recurrence oracle).  Tolerances: forward outputs within 3e-5 of the
largest reference value (the reference's kernel tolerance,
``tests/test_kernels.py``); gradients within 1e-4 x max(1, max|g|) per
input (fp32, different summation orders: chunked vs token recurrence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.kernels import ops as kops
from repro.kernels.rwkv6_scan import rwkv6_chunked_fwd
from repro.models import rwkv as jrwkv
import repro_torch.configs as tconfigs
from repro_torch.convert import tensor_from_numpy, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_bwd_plain, rwkv6_chunked_plain
from repro_torch.models import rwkv as trwkv

FWD_TOL = 3e-5
GRAD_TOL = 1e-4


def _rel(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.detach().numpy() - ref).max()) / max(float(np.abs(ref).max()), 1e-9)


def _grad_err(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _scan_inputs(seed, b, t, h, dk, log_decay=None):
    """r, k, v, decay w in (0, 1), u, as float32 numpy; the log-decay is
    -exp(N(-1, 0.5)) as in tests/test_kernels.py unless given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, dk)).astype(np.float32) for _ in range(3))
    if log_decay is None:
        log_decay = -np.exp(rng.standard_normal((b, t, h, dk)) * 0.5 - 1.0)
    w = np.exp(log_decay).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, dk))).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,t,h,dk", [(2, 128, 4, 32), (1, 100, 2, 64), (2, 64, 3, 16),
                                      (2, 77, 2, 32)])
def test_rwkv6_scan_matches_jax_forward_and_grads(b, t, h, dk):
    """ops.rwkv6_scan (CPU: the plain chunked version, chunk 16) against the
    JAX kernel (chunk 64, interpret mode) through its custom VJP; T=100 and
    77 are not multiples of either chunk."""
    r, k, v, w, u = _scan_inputs(t * h + dk, b, t, h, dk)
    g = np.random.default_rng(1).standard_normal((b, t, h, dk)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: kops.rwkv6_scan(*a)[0], *map(jnp.asarray, (r, k, v, w, u)))
    jgrads = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (r, k, v, w, u)]
    tout = ops.rwkv6_scan(*xs)
    tgrads = torch.autograd.grad(tout, xs, torch.from_numpy(g))
    assert _rel(tout, out) < FWD_TOL
    for name, a, ref in zip("rkvwu", tgrads, jgrads):
        assert _grad_err(a, ref) < GRAD_TOL, name


@pytest.mark.parametrize("b,t,h,dk,strong", [(2, 128, 4, 32, False), (1, 100, 2, 64, False),
                                             (2, 64, 3, 16, False), (2, 77, 2, 32, False),
                                             (1, 130, 2, 32, True)])
def test_closed_form_backward_matches_jax_vjp(b, t, h, dk, strong):
    """rwkv6_chunked_bwd_plain (the CUDA backward's statement: chunk states,
    a reverse G walk, d log-decay from the states at each chunk's end and a
    suffix sum over its rows) against jax.vjp of the
    reference op, all five gradients; ``strong``: per-step log-decay in
    [-2.5, -1.5], so a 64-token chunk's log-decay sum passes -88."""
    rng = np.random.default_rng(t * h + dk + 7)
    lw = -1.5 - rng.random((b, t, h, dk)) if strong else None
    r, k, v, w, u = _scan_inputs(t * h + dk + 1, b, t, h, dk, log_decay=lw)
    lw32 = np.log(w) if lw is None else lw.astype(np.float32)
    g = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    _, vjp = jax.vjp(lambda r, k, v, lw, u: kops.rwkv6_scan(r, k, v, jnp.exp(lw), u)[0],
                     *map(jnp.asarray, (r, k, v, lw32, u)))
    jgrads = vjp(jnp.asarray(g))
    tgrads = rwkv6_chunked_bwd_plain(*map(torch.from_numpy, (r, k, v, lw32, u, g)))
    assert all(bool(torch.isfinite(a).all()) for a in tgrads)
    for name, a, ref in zip(("dr", "dk", "dv", "dlog_w", "du"), tgrads, jgrads):
        assert a.shape == ref.shape and a.dtype == torch.float32, name
        assert _grad_err(a, ref) < GRAD_TOL, name


def test_chunked_plain_holds_to_the_recurrence_under_strong_decay():
    """Per-step log-decay down to -5: the plain chunked version stays
    finite and within 3e-5 of the recurrence, the port's and the JAX
    package's, while the TPU kernel's k * e^{-La} factor overflows there."""
    b, t, h, dk = 2, 128, 2, 32
    lw = -5.0 * np.random.default_rng(3).random((b, t, h, dk))
    r, k, v, w, u = _scan_inputs(4, b, t, h, dk, log_decay=lw)
    lw32 = lw.astype(np.float32)
    out = rwkv6_chunked_plain(*map(torch.from_numpy, (r, k, v, lw32, u)))
    rec, _ = trwkv.rwkv6_scan_plain(*map(torch.from_numpy, (r, k, v, w, u)))
    jref, _ = jrwkv.rwkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u)))
    assert torch.isfinite(out).all()
    assert _rel(out, rec.numpy()) < FWD_TOL
    assert _rel(out, jref) < FWD_TOL
    assert _rel(rec, jref) < FWD_TOL
    tpu = rwkv6_chunked_fwd(*map(jnp.asarray, (r, k, v, lw32, u)), interpret=True)
    assert not bool(jnp.isfinite(tpu).all())


def _split(a: torch.Tensor):
    """a ~= hi + lo, both bf16 values (held in fp32), as the kernel splits
    an fp32 operand for its bf16 tensor-core products."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _prod3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over two split operands: hi.hi + hi.lo + lo.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _rwkv6_tensor_core_mirror(r, k, v, log_w, u, chunk=64, sub=16):
    """The CUDA kernel's bf16 body in plain PyTorch: chunks of 64 in
    sub-blocks of 16, fp32 prefix sums; pairs in different sub-blocks
    through (r_t e^{La_{t-1} - La_ref}) . (k_s e^{La_ref - La_s}) with the
    reference point the row before t's sub-block, the diagonal sub-blocks
    and the u bonus pairwise; P.v, the inter term (the r factor times
    e^{La_ref}) and the state update over bf16 operands with fp32 sums, the
    fp32 operands split into hi + lo.  Returns fp32 out (B, T, H, K)."""
    b, t, h, dk = r.shape
    perm = lambda a: a.permute(0, 2, 1, 3)                      # (B, H, T, K)
    r, k, v, log_w = map(perm, (r, k, v, log_w))
    s_t = torch.zeros((b, h, dk, dk))                           # S^T[j, kch]
    out = torch.empty((b, h, t, dk))
    for c0 in range(0, t, chunk):
        rows = min(chunk, t - c0)

        def pad(a):
            o = torch.zeros((b, h, chunk, dk))
            o[:, :, :rows] = a[:, :, c0:c0 + rows]
            return o
        rc, kc, vc, ld = map(pad, (r, k, v, log_w))
        la = torch.cumsum(ld, dim=2)                            # La_t
        lp = torch.cat([torch.zeros((b, h, 1, dk)), la[:, :, :-1]], dim=2)   # La_{t-1}
        oc = torch.zeros((b, h, chunk, dk))
        for w in range(chunk // sub):
            rows_w = slice(sub * w, sub * (w + 1))
            lref = lp[:, :, sub * w:sub * w + 1]                # La_{16w - 1}
            rt = rc[:, :, rows_w] * torch.exp(lp[:, :, rows_w] - lref)
            p = torch.zeros((b, h, sub, chunk))
            if w:
                kt = kc[:, :, :sub * w] * torch.exp(lref - la[:, :, :sub * w])
                p[..., :sub * w] = _prod3(rt, kt.transpose(-1, -2))
            # the diagonal sub-block pairwise, the bonus on its diagonal
            t_idx, s_idx = torch.tril_indices(sub, sub, -1)
            tg, sg = sub * w + t_idx, sub * w + s_idx
            pair = (rc[:, :, tg] * kc[:, :, sg] * torch.exp(lp[:, :, tg] - la[:, :, sg])).sum(-1)
            p[:, :, t_idx, sg] = pair
            diag = torch.arange(sub)
            p[:, :, diag, sub * w + diag] = (rc[:, :, rows_w] * u[None, :, None] *
                                              kc[:, :, rows_w]).sum(-1)
            ph, pl = _split(p)
            oc[:, :, rows_w] = (ph @ vc + pl @ vc
                                + _prod3(rt * torch.exp(lref), s_t.transpose(-1, -2)))
        out[:, :, c0:c0 + rows] = oc[:, :, :rows]
        kd_hi, kd_lo = _split(kc * torch.exp(la[:, :, -1:] - la))
        s_t = (torch.exp(la[:, :, -1:]) * s_t
               + vc.transpose(-1, -2) @ kd_hi + vc.transpose(-1, -2) @ kd_lo)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,t,h,dk,strong", [(2, 150, 3, 32, False), (1, 65, 2, 64, False),
                                             (1, 128, 2, 32, True)])
def test_tensor_core_decomposition_matches_jax(b, t, h, dk, strong):
    """The bf16 body's algebra, checked without a card: on inputs whose r,
    k and v are bf16 values, the mirror (sub-block reference points, hi +
    lo splits) agrees with the JAX kernel in interpret mode within 3e-5 of
    max|ref|, and under strong decay (per-step log-decay down to -5),
    where the TPU kernel overflows, with the JAX recurrence.  T = 65 and
    150 leave ragged tails."""
    rng = np.random.default_rng(t + dk)
    lw = -5.0 * rng.random((b, t, h, dk)) if strong else None
    r, k, v, w, u = _scan_inputs(t * h + dk, b, t, h, dk, log_decay=lw)
    r, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (r, k, v))
    lw32 = np.log(w) if lw is None else lw.astype(np.float32)
    out = _rwkv6_tensor_core_mirror(*map(torch.from_numpy, (r, k, v, lw32.astype(np.float32),
                                                            u)))
    assert torch.isfinite(out).all()
    if strong:
        ref, _ = jrwkv.rwkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u)))
    else:
        ref = rwkv6_chunked_fwd(*map(jnp.asarray, (r, k, v, lw32.astype(np.float32), u)),
                                interpret=True)
    assert _rel(out, ref) < FWD_TOL


def test_scan_plain_carries_state_like_jax():
    """The token recurrence from a given state, with its final state."""
    b, t, h, dk = 1, 20, 2, 16
    r, k, v, w, u = _scan_inputs(5, b, t, h, dk)
    s0 = np.random.default_rng(6).standard_normal((b, h, dk, dk)).astype(np.float32)
    out, s = trwkv.rwkv6_scan_plain(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    jout, js = jrwkv.rwkv6_scan_ref(*map(jnp.asarray, (r, k, v, w, u, s0)))
    assert _rel(out, jout) < FWD_TOL
    assert _rel(s, js) < FWD_TOL


@pytest.fixture(scope="module")
def rwkv_params():
    cfg = reduced_config(get_config("rwkv6-1.6b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("rwkv6-1.6b"))
    p = jrwkv.init_rwkv6(jax.random.key(0), cfg, jnp.float32)
    # the init's mu is a constant 0.5: vary it so a wrong shift index shows
    mu = np.random.default_rng(7).uniform(0, 1, (5, cfg.d_model)).astype(np.float32)
    mu_c = np.random.default_rng(8).uniform(0, 1, (2, cfg.d_model)).astype(np.float32)
    p = dict(p, mu=jnp.asarray(mu), mu_c=jnp.asarray(mu_c))
    tp = tree_map(tensor_from_numpy, jax.tree.map(np.asarray, p))
    return cfg, tcfg, p, tp


@pytest.mark.parametrize("uk", [False, True], ids=["plain", "kernels"])
def test_tmix_and_cmix_match_jax(rwkv_params, uk):
    cfg, tcfg, p, tp = rwkv_params
    x = np.random.default_rng(9).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jout, _ = jrwkv.apply_rwkv6_tmix(p, cfg, jnp.asarray(x), use_kernels=uk)
    tout, tstate = trwkv.apply_rwkv6_tmix(tp, tcfg, torch.from_numpy(x))
    assert _rel(tout, jout) < 1e-5 and tstate is None
    jc, jlast = jrwkv.apply_rwkv6_cmix(p, cfg, jnp.asarray(x))
    tc, tlast = trwkv.apply_rwkv6_cmix(tp, tcfg, torch.from_numpy(x))
    assert _rel(tc, jc) < 1e-5 and _rel(tlast, jlast) == 0.0


def test_init_matches_jax_shapes_and_dtypes():
    cfg = reduced_config(get_config("rwkv6-1.6b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("rwkv6-1.6b"))
    jp = jrwkv.init_rwkv6(jax.random.key(0), cfg, jnp.bfloat16)
    tp = trwkv.init_rwkv6(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert tuple(jp[name].shape) == tuple(tp[name].shape), name
        assert str(jp[name].dtype) == str(tp[name].dtype).removeprefix("torch."), name
    assert torch.equal(tp["w0"], torch.full((tcfg.d_model,), -4.0))


def test_params_from_jax_carries_rwkv_blocks_and_fp32_leaves():
    """The stacked JAX rwkv LM (bf16 params) converts to one dict per layer
    with its ``rwkv`` sub-dict; w0 and u stay fp32, every value bit-equal,
    and the tree has the port's own init structure."""
    from repro.models.api import build_model
    from repro.configs import RunConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model as tbuild_model
    cfg = reduced_config(get_config("rwkv6-1.6b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("rwkv6-1.6b"))
    jp = jax.tree.map(np.asarray, build_model(cfg, RunConfig()).init(jax.random.key(0)))
    tp = params_from_jax(jp, device="cpu")
    assert len(tp["blocks"]) == cfg.n_layers
    shapes = lambda t: jax.tree.map(lambda x: (tuple(x.shape), x.dtype), t)
    own = tbuild_model(tcfg, tconfigs.RunConfig(), device="cpu").init(0)
    assert shapes(tp) == shapes(own)
    for i, bp in enumerate(tp["blocks"]):
        assert bp["rwkv"]["w0"].dtype == bp["rwkv"]["u"].dtype == torch.float32
        assert bp["rwkv"]["wr"].dtype == torch.bfloat16
        assert np.array_equal(bp["rwkv"]["wr"].view(torch.int16).numpy(),
                              jp["blocks"]["rwkv"]["wr"][i].view(np.int16))
        assert np.array_equal(bp["rwkv"]["u"].numpy(), jp["blocks"]["rwkv"]["u"][i])
