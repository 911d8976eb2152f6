"""Chunked WKV6 recurrence: the Hopper kernel's wrapper and its plain version.

The kernel (``csrc/rwkv6_scan.cu``) replaces the TPU kernel
``repro/kernels/rwkv6_scan.py::rwkv6_chunked_fwd``.  bf16 inputs take its
tensor-core body: a CTA per (batch, head) walks chunks of 64 in sub-blocks
of 16, its warps splitting the rows and the two halves of V, the pairs
across sub-blocks (and across the 8-token halves of one) through products
of decay-scaled r and k about a reference point between them, the chunk
products on mma.sync with the fp32 operands split into hi + lo bf16 terms.
fp32 inputs (the parity runs) take a scalar body, one CTA per (batch, head)
and chunks of 16.

Neither version forms a positive exponent: the plain version takes the
intra-chunk decay ratio ``e^{La_{t-1} - La_s}`` (``s < t``) pairwise, the
kernel pairwise or as two factors ``<= 1`` about a reference point between
``s`` and ``t - 1``.  The TPU kernel's ``k * e^{-La}`` factor overflows fp32 once a chunk's
log-decay sum passes about -88 (a per-step log-decay of -1.5 over its
64-token chunk); both versions here stay finite there and are held to the
token recurrence (``models/rwkv.py::rwkv6_scan_plain``) instead.

:func:`rwkv6_chunked_plain` is the same chunked function in PyTorch; the
wrapper routes CPU tensors to it.

The backward (``csrc/rwkv6_bwd.cu``, :func:`rwkv6_bwd_cuda`) replaces no TPU
kernel: the reference's backward is the AD of its recurrence oracle.  It
computes the gradients in closed form in fp32, one CTA per (batch, head):
a forward walk writes the state before each 16-token chunk to a scratch, a
reverse walk carries the state's gradient back over the chunks, d
log-decay starting each chunk from the row sums of (gradient * state) at
its end.  :func:`rwkv6_chunked_bwd_plain` is its statement in
PyTorch.  ``ops.rwkv6_scan``'s backward chooses by the inputs' dtype: bf16
r/k/v (the training runs) take the kernel, fp32 ones (the parity runs and
fp32 fleets) autograd through :func:`rwkv6_chunked_plain`; there is no
other switch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches made by rwkv6_cuda and by rwkv6_bwd_cuda in this process
launches = 0
bwd_launches = 0

PLAIN_CHUNK = 16            # keeps the (c, c, K) ratio tensor ~0.5 GB at B 8, T 512, H 32
HEAD_DIMS = (32, 64)          # rwkv6 reduced and full width
BWD_CHUNK = 16                # tokens a chunk of the backward kernel (its state scratch)

_DT = {torch.float32: _build.DT_F32, torch.bfloat16: _build.DT_BF16}
_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BWD_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def rwkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v (B,T,H,K); log_w (B,T,H,K) log-decay (<= 0); u (H,K).
    Returns out (B,T,H,K) in r's dtype; computes in fp32.

    Chunk-local terms for all chunks at once, then the (K, K) state carried
    over the chunks in order.  Tail rows are zero with decay 1, so they add
    nothing to the state, and their outputs are dropped."""
    b, t, h, dk = r.shape
    c = min(PLAIN_CHUNK, t)
    pad = (-t) % c
    n = (t + pad) // c

    def prep(a):                                   # (B,T,H,K) -> (B,H,n,c,K) fp32
        a = a.float().permute(0, 2, 1, 3)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.reshape(b, h, n, c, dk)

    rr, kk, vv, ld = prep(r), prep(k), prep(v), prep(log_w)
    la = torch.cumsum(ld, dim=3)                   # inclusive prefix La_t
    lp = la - ld                                   # exclusive prefix La_{t-1}
    la_end = la[:, :, :, -1:, :]                   # La_c, (B,H,n,1,K)
    # intra: P[t,s] = sum_k r_tk k_sk e^{La_{t-1,k} - La_{s,k}} for s < t
    below = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    diff = lp[:, :, :, :, None, :] - la[:, :, :, None, :, :]            # (B,H,n,c,c,K)
    ratio = torch.exp(torch.where(below[:, :, None], diff, float("-inf")))
    p = (rr[:, :, :, :, None, :] * kk[:, :, :, None, :, :] * ratio).sum(-1)
    bonus = (rr * u.float()[None, :, None, None, :] * kk).sum(-1)       # (B,H,n,c)
    p = p + torch.diag_embed(bonus)
    out = p @ vv                                                        # (B,H,n,c,K)
    # inter: (r_t e^{La_{t-1}}) S_0, with S carried over the chunks
    rq = rr * torch.exp(lp)
    ds = (kk * torch.exp(la_end - la)).transpose(-1, -2) @ vv           # (B,H,n,K,K)
    decay = torch.exp(la_end).transpose(-1, -2)                         # (B,H,n,K,1)
    s = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    inter = []
    for i in range(n):
        inter.append(rq[:, :, i] @ s)
        s = decay[:, :, i] * s + ds[:, :, i]
    out = out + torch.stack(inter, dim=2)
    out = out.reshape(b, h, n * c, dk)[:, :, :t].permute(0, 2, 1, 3)
    return out.to(r.dtype)


def rwkv6_chunked_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            log_w: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """The gradients of :func:`rwkv6_chunked_plain` in closed form, in fp32:
    ``(dr, dk, dv, dlog_w, du)`` for the output gradient g (B,T,H,K), dr/dk/dv
    in r's dtype, dlog_w and du fp32.  The statement of what
    :func:`rwkv6_bwd_cuda` computes; nothing on the card's path calls it.

    Per head, with S_t the state after token t, ld_t the log-decay and
    G_t = dL/dS_t carried backwards, G_{t-1} = diag(e^{ld_t}) G_t + r_t g_t^T:
    dr_t = S_{t-1} g_t + (u k_t)(v_t . g_t), dk_t = G_t v_t + (u r_t)(v_t . g_t),
    dv_t = G_t^T k_t + (r_t . u k_t) g_t, du = sum r_t k_t (v_t . g_t), and
    d ld_j = sum_{t>j} r_t drI_t - sum_{s>=j} k_s dkI_s, drI and dkI being
    dr and dk without their u terms; the first sum less the rest of the
    second is W_j, the row sum of G_j * S_j.  Over chunks: S before each
    chunk from a forward walk, G after each chunk from a reverse walk, the
    pairs inside a chunk through the same decay ratios as the forward (no
    positive exponent), and d ld from W at each chunk's end and a suffix
    sum over the chunk's rows."""
    b, t, h, dk = r.shape
    c = min(PLAIN_CHUNK, t)
    pad = (-t) % c
    n = (t + pad) // c

    def prep(a):                                   # (B,T,H,K) -> (B,H,n,c,K) fp32
        a = a.float().permute(0, 2, 1, 3)
        if pad:
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return a.reshape(b, h, n, c, dk)

    rr, kk, vv, ld, gg = prep(r), prep(k), prep(v), prep(log_w), prep(g)
    uf = u.float()[None, :, None, None, :]
    la = torch.cumsum(ld, dim=3)                   # La_t
    lp = la - ld                                   # La_{t-1}
    la_end = la[:, :, :, -1:, :]
    below = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    # ratio[t, s, k] = e^{La_{t-1,k} - La_{s,k}} for s < t, else 0
    ratio = torch.exp(torch.where(below[:, :, None], lp[:, :, :, :, None, :]
                                  - la[:, :, :, None, :, :], float("-inf")))
    a = gg @ vv.transpose(-1, -2)                  # A[t, s] = g_t . v_s
    a_below = a * below
    p = (rr[:, :, :, :, None, :] * kk[:, :, :, None, :, :] * ratio).sum(-1)
    p = p + torch.diag_embed((rr * uf * kk).sum(-1))        # the bonus on the diagonal
    kd = kk * torch.exp(la_end - la)               # k_s e^{La_c - La_s}
    rq = rr * torch.exp(lp)                        # r_t e^{La_{t-1}}
    decay = torch.exp(la_end).transpose(-1, -2)    # (B,H,n,K,1)
    s = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    s0 = []
    for i in range(n):                             # S before each chunk
        s0.append(s)
        s = decay[:, :, i] * s + kd[:, :, i].transpose(-1, -2) @ vv[:, :, i]
    gs = torch.zeros_like(s)
    g_end = [gs] * n
    for i in reversed(range(n)):                   # G after each chunk
        g_end[i] = gs
        gs = decay[:, :, i] * gs + rq[:, :, i].transpose(-1, -2) @ gg[:, :, i]
    s_end = torch.stack(s0[1:] + [s], dim=2)       # S after each chunk
    s0, g_end = torch.stack(s0, dim=2), torch.stack(g_end, dim=2)
    dr_i = torch.exp(lp) * (gg @ s0.transpose(-1, -2)) \
        + torch.einsum("...ts,...sk,...tsk->...tk", a_below, kk, ratio)
    dk_i = torch.exp(la_end - la) * (vv @ g_end.transpose(-1, -2)) \
        + torch.einsum("...ts,...tk,...tsk->...sk", a_below, rr, ratio)
    dv = kd @ g_end + p.transpose(-1, -2) @ gg
    diag = torch.diagonal(a, dim1=-2, dim2=-1)[..., None]  # v_t . g_t
    dr = dr_i + uf * kk * diag
    dkk = dk_i + uf * rr * diag
    du = (rr * kk * diag).sum(dim=(0, 2, 3))
    # d ld_j = W_j - k_j dkI_j with W_j = sum_{t>j} (r_t drI_t - k_t dkI_t),
    # which is the row sum of G_j * S_j: W at each chunk's end from the
    # states, then the suffix over the chunk's own rows
    y = kk * dk_i
    z = rr * dr_i - y
    w_end = (g_end * s_end).sum(-1)[:, :, :, None, :]               # (B,H,n,1,K)
    dld = w_end + torch.flip(torch.cumsum(torch.flip(z, (3,)), 3), (3,)) - z - y

    def back(x):                                   # (B,H,n,c,K) -> (B,T,H,K)
        return x.reshape(b, h, n * c, dk)[:, :, :t].permute(0, 2, 1, 3)
    return (back(dr).to(r.dtype), back(dkk).to(k.dtype), back(dv).to(v.dtype),
            back(dld).contiguous(), du)


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`rwkv6_chunked_plain`, on a CUDA device:
    r/k/v contiguous float32 or bfloat16 of one dtype, log_w and u
    contiguous float32, head dim in ``HEAD_DIMS``."""
    global launches
    b, t, h, dk = r.shape
    dev = r.device
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, log_w, u)):
        raise ValueError("rwkv6_cuda needs r, k, v, log_w, u on one CUDA device")
    if r.dtype not in _DT or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"log_w and u must be float32, got {log_w.dtype}, {u.dtype}")
    if any(tuple(a.shape) != (b, t, h, dk) for a in (k, v, log_w)) or \
            tuple(u.shape) != (h, dk):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"log_w {tuple(log_w.shape)}, u {tuple(u.shape)} do not match")
    if dk not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes head dims {HEAD_DIMS}, got {dk}")
    if not all(a.is_contiguous() for a in (r, k, v, log_w, u)):
        raise ValueError("rwkv6_cuda needs contiguous r, k, v, log_w, u")
    out = torch.empty_like(r)
    if b == 0 or t == 0 or h == 0:
        return out
    fn = _build.function("rwkv6_scan", "rwkv6_fwd", _ARGS)
    stream = _build.stream(dev)
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                    out.data_ptr(), b, t, h, dk, _DT[r.dtype], stream), "rwkv6_fwd")
    launches += 1
    return out


def rwkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                   u: torch.Tensor, g: torch.Tensor):
    """The gradients of :func:`rwkv6_cuda`'s output for the output gradient
    g, on a CUDA device: ``(dr, dk, dv, dlog_w, du)`` as
    :func:`rwkv6_chunked_bwd_plain` gives them.  r/k/v/g contiguous
    bfloat16 (the training runs; fp32 ones take the plain VJP), log_w and u
    contiguous float32, head dim in ``HEAD_DIMS``.  Allocates a float32
    scratch of the state before each chunk, (B, H, ceil(T / 16), K, K), and
    du's per-(batch, head) partials, summed here."""
    global bwd_launches
    b, t, h, dk = r.shape
    dev = r.device
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, log_w, u, g)):
        raise ValueError("rwkv6_bwd_cuda needs r, k, v, log_w, u, g on one CUDA device")
    if any(a.dtype != torch.bfloat16 for a in (r, k, v, g)):
        raise TypeError(f"r/k/v/g must be bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{g.dtype}")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"log_w and u must be float32, got {log_w.dtype}, {u.dtype}")
    if any(tuple(a.shape) != (b, t, h, dk) for a in (k, v, log_w, g)) or \
            tuple(u.shape) != (h, dk):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"log_w {tuple(log_w.shape)}, u {tuple(u.shape)}, g {tuple(g.shape)} "
                         f"do not match")
    if dk not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes head dims {HEAD_DIMS}, got {dk}")
    if not all(a.is_contiguous() for a in (r, k, v, log_w, u, g)):
        raise ValueError("rwkv6_bwd_cuda needs contiguous r, k, v, log_w, u, g")
    dr, dkk, dv, dlw = (torch.empty_like(a) for a in (r, k, v, log_w))
    if b == 0 or t == 0 or h == 0:
        return dr, dkk, dv, dlw, torch.zeros_like(u)
    du = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, -(-t // BWD_CHUNK), dk, dk), dtype=torch.float32, device=dev)
    fn = _build.function("rwkv6_bwd", "rwkv6_bwd", _BWD_ARGS)
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
                    g.data_ptr(), dr.data_ptr(), dkk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
                    du.data_ptr(), states.data_ptr(), b, t, h, dk, _build.stream(dev)),
                 "rwkv6_bwd")
    bwd_launches += 1
    return dr, dkk, dv, dlw, du.sum(0)
