"""The port's Mamba2 SSD pieces against the JAX package, same inputs, fp32.

Inputs come from seeded numpy generators and go to both packages; the JAX
SSD kernel runs in interpret mode (its custom VJP differentiates the token
recurrence).  Tolerances: forward outputs and final states within 3e-5 of
the largest reference value (the reference's kernel tolerance,
``tests/test_kernels.py``); gradients within 1e-4 x max(1, max|g|) per
input (fp32, different summation orders: chunked vs token recurrence);
the Mamba2 block within 1e-5 x max(1, max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.kernels import ops as kops
from repro.kernels.mamba2_ssd import mamba2_ssd_fwd
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch.convert import tensor_from_numpy, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_chunked_plain
from repro_torch.models import ssm as tssm

FWD_TOL = 3e-5
GRAD_TOL = 1e-4
BLOCK_TOL = 1e-5


def _rel(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.detach().numpy() - ref).max()) / max(float(np.abs(ref).max()), 1e-9)


def _grad_err(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.numpy() - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _ssd_inputs(seed, b, t, h, p, n, strong=False):
    """x, dt, A, B, C, D as float32 numpy, drawn like tests/test_kernels.py
    (dt = softplus(N(0, 1)), A = -exp(0.3 N)), D ~ 1 + 0.1 N; ``strong``:
    dt uniform in [0, 5] and A = -16, so a 64-token chunk's log-decay
    reaches ~ -5000."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    if strong:
        dt = (5.0 * rng.random((b, t, h))).astype(np.float32)
        A = np.full((h,), -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
        A = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    B, C = (rng.standard_normal((b, t, n)).astype(np.float32) for _ in range(2))
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(2, 96, 3, 32, 16, 32), (1, 64, 2, 64, 32, 16),
                                             (2, 50, 4, 16, 8, 25)])
def test_chunked_plain_matches_jax_kernel_and_recurrence(b, t, h, p, n, chunk):
    """The reference's sweep: the plain chunked version at the sweep's chunk
    and at the CUDA kernel's chunk of 64 (T=50 and 96 leave a tail),
    against the TPU kernel in interpret mode and the recurrence oracle."""
    args = _ssd_inputs(t + h + p + n, b, t, h, p, n)
    jy, js = mamba2_ssd_fwd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    ry, rs = jssm.mamba2_scan_ref(*map(jnp.asarray, args))
    for c in (chunk, 64):
        y, s = mamba2_ssd_chunked_plain(*map(torch.from_numpy, args), chunk=c)
        assert y.shape == (b, t, h, p) and s.shape == (b, h, p, n)
        for ref_y, ref_s in ((jy, js), (ry, rs)):
            assert _rel(y, ref_y) < FWD_TOL, c
            assert _rel(s, ref_s) < FWD_TOL, c


def test_scan_plain_matches_jax_recurrence_from_a_state():
    b, t, h, p, n = 2, 20, 3, 16, 8
    args = _ssd_inputs(1, b, t, h, p, n)
    s0 = np.random.default_rng(2).standard_normal((b, h, p, n)).astype(np.float32)
    y, s = tssm.mamba2_scan_plain(*map(torch.from_numpy, args + (s0,)))
    jy, js = jssm.mamba2_scan_ref(*map(jnp.asarray, args + (s0,)))
    assert _rel(y, jy) < FWD_TOL and _rel(s, js) < FWD_TOL


def _loss_grads_jax(args, g):
    def f(*a):
        y, _ = kops.mamba2_ssd(*a)
        return jnp.sum(y * jnp.asarray(g))
    return jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, args))


def _port_grads(args, g):
    xs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, _ = ops.mamba2_ssd(*xs)
    return y, torch.autograd.grad(y, xs, torch.from_numpy(g))


@pytest.mark.parametrize("b,t,h,p,n", [(2, 80, 3, 32, 16), (1, 64, 2, 16, 8)])
def test_ssd_gradients_match_jax(b, t, h, p, n):
    """Gradients of ops.mamba2_ssd (CPU: through the plain chunked version)
    for x, dt, A, B, C and D against jax.grad through the reference's
    ops.mamba2_ssd (interpret kernel forward, recurrence-oracle VJP)."""
    args = _ssd_inputs(7 * t + n, b, t, h, p, n)
    g = np.random.default_rng(3).standard_normal((b, t, h, p)).astype(np.float32)
    _, tgrads = _port_grads(args, g)
    jgrads = _loss_grads_jax(args, g)
    for name, a, ref in zip(("x", "dt", "A", "B", "C", "D"), tgrads, jgrads):
        assert _grad_err(a, ref) < GRAD_TOL, name


def test_loss_on_the_final_state_gives_the_reference_gradients():
    """The reference drops the final state's cotangent (its ``_ssd_b``): a
    loss on y and on the state gives y's gradients only.  The port's CPU
    route hands back a state that carries no gradient, as the card does."""
    b, t, h, p, n = 1, 70, 2, 16, 8
    args = _ssd_inputs(5, b, t, h, p, n)

    def f(*a):
        y, s = kops.mamba2_ssd(*a)
        return jnp.sum(y) + jnp.sum(s)
    jgrads = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = ops.mamba2_ssd(*xs)
    assert not s.requires_grad
    tgrads = torch.autograd.grad(y.sum() + s.sum(), xs)
    for name, a, ref in zip(("x", "dt", "A", "B", "C", "D"), tgrads, jgrads):
        assert _grad_err(a, ref) < GRAD_TOL, name


def test_strong_decay_stays_finite_and_matches_the_recurrence():
    """dt up to 5 at A = -16: the chunk's log-decay reaches ~ -5000.  The
    plain version masks the exponent before exp, so forward and gradients
    are finite and agree with the recurrence (JAX's and the port's) and
    with JAX's gradients; ``where(mask, exp(d), 0)`` would give NaN
    gradients here."""
    b, t, h, p, n = 1, 130, 2, 32, 16
    args = _ssd_inputs(11, b, t, h, p, n, strong=True)
    y, s = mamba2_ssd_chunked_plain(*map(torch.from_numpy, args))
    ry, rs = jssm.mamba2_scan_ref(*map(jnp.asarray, args))
    py, ps = tssm.mamba2_scan_plain(*map(torch.from_numpy, args))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _rel(y, ry) < FWD_TOL and _rel(s, rs) < FWD_TOL
    assert _rel(py, ry) < FWD_TOL and _rel(ps, rs) < FWD_TOL
    g = np.random.default_rng(4).standard_normal((b, t, h, p)).astype(np.float32)
    _, tgrads = _port_grads(args, g)
    jgrads = _loss_grads_jax(args, g)
    for name, a, ref in zip(("x", "dt", "A", "B", "C", "D"), tgrads, jgrads):
        assert torch.isfinite(a).all(), name
        assert _grad_err(a, ref) < GRAD_TOL, name
    # the same chunk math with the mask after the exponential: NaN gradients
    d = torch.tensor([[0.0, 100.0], [-100.0, 0.0]], requires_grad=True)
    mask = torch.tensor([[True, False], [True, True]])
    after = torch.where(mask, torch.exp(d), torch.zeros(()))
    assert torch.isnan(torch.autograd.grad(after.sum(), d)[0]).any()


def _split(a: torch.Tensor):
    """a ~= hi + lo, both bf16 values (held in fp32), as the kernel splits
    an fp32 operand for its bf16 tensor-core products."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _ssd_tensor_core_mirror(x, dt, A, B, C, D, chunk=64):
    """The CUDA kernel's bf16 body in plain PyTorch: chunks of 64, fp64
    prefix sums, C.B^T once per (batch, chunk) for every head, and every
    product over bf16 operands with fp32 sums -- x, B and C exact, while
    G, the state S and (w x) are split into hi + lo bf16 terms.  Returns
    fp32 y (before the kernel's final bf16 rounding) and the final state."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    s = torch.zeros((b, h, p, n))
    y = torch.empty((b, t, h, p))
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    for c0 in range(0, t, chunk):
        rows = min(chunk, t - c0)

        def pad(a):                          # the chunk's rows, zeros past the sequence
            out = torch.zeros((b, chunk) + a.shape[2:], dtype=a.dtype)
            out[:, :rows] = a[:, c0:c0 + rows]
            return out
        xc, bc, cc, dtc = pad(x), pad(B), pad(C), pad(dt)
        cb = cc @ bc.transpose(1, 2)                                   # (b, c, c): shared
        la = torch.cumsum(dtc.double() * A.double(), dim=1)            # (b, c, h) fp64
        diff = (la[:, :, None, :] - la[:, None, :, :]).float()         # (b, t, s, h)
        decay = torch.where(causal[None, :, :, None], torch.exp(diff.clamp_max(0.0)),
                            torch.zeros(()))
        g = cb[..., None] * decay * dtc[:, None, :, :]                 # (b, t, s, h)
        g_hi, g_lo = _split(g)
        s_hi, s_lo = _split(s)
        inter = torch.einsum("btn,bhpn->bthp", cc, s_hi) + torch.einsum("btn,bhpn->bthp", cc, s_lo)
        intra = (torch.einsum("btsh,bshp->bthp", g_hi, xc)
                 + torch.einsum("btsh,bshp->bthp", g_lo, xc))
        yc = torch.exp(la).float()[..., None] * inter + intra + D[:, None] * xc
        y[:, c0:c0 + rows] = yc[:, :rows]
        w = torch.exp((la[:, -1:] - la).float()) * dtc                 # (b, c, h)
        wx_hi, wx_lo = _split(w[..., None] * xc)
        s = (torch.exp(la[:, -1].float())[..., None, None] * s
             + torch.einsum("bshp,bsn->bhpn", wx_hi, bc) + torch.einsum("bshp,bsn->bhpn", wx_lo, bc))
    return y, s


@pytest.mark.parametrize("b,t,h,p,n,strong", [(2, 150, 3, 32, 16, False), (1, 65, 2, 64, 64, False),
                                              (1, 130, 2, 32, 16, True)])
def test_tensor_core_decomposition_matches_jax(b, t, h, p, n, strong):
    """The bf16 body's algebra, checked without a card: on inputs whose x, B
    and C are bf16 values, the mirror (head-shared C.B^T, hi + lo splits of
    G, S and w x) agrees with the JAX SSD kernel in interpret mode within
    3e-5 of max|ref| for y and the final state, and under strong decay
    (dt up to 5, A = -16), where the TPU kernel's factoring overflows, with
    the JAX recurrence.  T = 65, 130 and 150 leave ragged tails."""
    x, dt, A, B, C, D = _ssd_inputs(t + h + p, b, t, h, p, n, strong=strong)
    x, B, C = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (x, B, C))
    args = (x, dt, A, B, C, D)
    y, s = _ssd_tensor_core_mirror(*map(torch.from_numpy, args))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    if strong:
        ry, rs = jssm.mamba2_scan_ref(*map(jnp.asarray, args))
    else:
        ry, rs = mamba2_ssd_fwd(*map(jnp.asarray, args), chunk=64, interpret=True)
    assert _rel(y, ry) < FWD_TOL and _rel(s, rs) < FWD_TOL


@pytest.fixture(scope="module")
def mamba_params():
    cfg = reduced_config(get_config("zamba2-7b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("zamba2-7b"))
    p = jssm.init_mamba2(jax.random.key(0), cfg, jnp.float32)
    # the init's conv bias is 0 and norm scale 1: vary them so a wrong
    # broadcast shows
    rng = np.random.default_rng(5)
    p = dict(p, conv_b=jnp.asarray(0.1 * rng.standard_normal(p["conv_b"].shape), jnp.float32),
             norm_scale=jnp.asarray(1 + 0.1 * rng.standard_normal(p["norm_scale"].shape),
                                    jnp.float32))
    tp = tree_map(tensor_from_numpy, jax.tree.map(np.asarray, p))
    return cfg, tcfg, p, tp


@pytest.mark.parametrize("uk", [False, True], ids=["jax-plain", "jax-kernels"])
def test_apply_mamba2_matches_jax(mamba_params, uk):
    cfg, tcfg, p, tp = mamba_params
    x = np.random.default_rng(9).standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    jout, _ = jssm.apply_mamba2(p, cfg, jnp.asarray(x), use_kernels=uk)
    tout, _ = tssm.apply_mamba2(tp, tcfg, torch.from_numpy(x))
    ref = np.asarray(jout)
    assert np.abs(tout.detach().numpy() - ref).max() <= BLOCK_TOL * max(1.0, np.abs(ref).max())


def test_init_mamba2_matches_jax_shapes_and_dtypes():
    """bf16 params, with A_log, D and dt_bias fp32 as in the reference; the
    deterministic leaves equal the reference's."""
    cfg = reduced_config(get_config("zamba2-7b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("zamba2-7b"))
    jp = jssm.init_mamba2(jax.random.key(0), cfg, jnp.bfloat16)
    tp = tssm.init_mamba2(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert tuple(jp[name].shape) == tuple(tp[name].shape), name
        assert str(jp[name].dtype) == str(tp[name].dtype).removeprefix("torch."), name
    for name in ("A_log", "D", "dt_bias"):
        assert np.allclose(tp[name].numpy(), np.asarray(jp[name]), rtol=1e-6), name
