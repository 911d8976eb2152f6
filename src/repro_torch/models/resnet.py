"""ResNet-34, the paper's own experiment model (§4.1); port of
``repro/models/resnet.py``.

An explicit list of blocks, so the heterogeneous partitioner can split it
at any block boundary (the paper hand-picked splits like "before Layer3
Block4"); :func:`block_costs` gives per-block FLOPs and boundary bytes for
the cost model.  BatchNorm runs on batch statistics (training).

The reference's interface is kept: images NHWC, conv weights HWIO, the
same block list and param dicts.  Inside, ``F.conv2d`` and
``F.max_pool2d`` stand for ``lax.conv_general_dilated`` and
``lax.reduce_window`` (library calls in the reference too, outside any
Pallas kernel).  XLA's "SAME" padding puts the odd pixel of a stride-2
window at the high end (a 3x3 stride-2 conv on 56x56 pads 0 before and 1
after), which ``padding=`` cannot say; :func:`same_pad` computes XLA's
amounts and ``F.pad`` applies them (with -inf before the max-pool).  The
variance is the biased one, by ``jnp.var``'s formula.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet34 import ResNetConfig


def same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim of size ``n`` for a window
    ``k`` at ``stride``: (low, high), the odd pixel at the high end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad`` amounts (W low, W high, H low, H high) of NCHW ``x``."""
    h, w = same_pad(x.shape[2], k, stride), same_pad(x.shape[3], k, stride)
    return w + h


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` by HWIO ``w`` with XLA's "SAME" padding."""
    xc = x.permute(0, 3, 1, 2)
    pads = _pads(xc, w.shape[0], stride)
    if pads[0] == pads[1] == pads[2] == pads[3]:       # symmetric: the conv pads itself
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pads[0])
    else:
        y = F.conv2d(F.pad(xc, pads), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    xc = x.permute(0, 3, 1, 2)
    xc = F.pad(xc, _pads(xc, k, stride), value=float("-inf"))
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def _bn(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    # jnp.var's formula: torch.var's backward lost 6e-2 of a gradient's
    # max to the reference (and to float64) on one ResNet-34 at 64 px
    var = torch.square(x - mu).mean(dim=(0, 1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _init_conv(gen: torch.Generator, k: int, cin: int, cout: int) -> torch.Tensor:
    fan_in = k * k * cin
    return torch.randn((k, k, cin, cout), generator=gen,
                       device=gen.device) * (2.0 / fan_in) ** 0.5


def _init_bn(c: int, device) -> dict:
    return {"scale": torch.ones((1, 1, 1, c), device=device),
            "bias": torch.zeros((1, 1, 1, c), device=device)}


def init_resnet(cfg: ResNetConfig, gen: torch.Generator) -> Tuple[List[dict], List[dict]]:
    """(meta, params): ordered block lists, fp32 on ``gen``'s device.
    ``meta`` holds static structure (kind, stride), ``params`` only
    tensors."""
    dev = gen.device
    meta: List[dict] = [{"kind": "stem"}]
    params: List[dict] = [{"conv": _init_conv(gen, 7, 3, cfg.channels[0]),
                           "bn": _init_bn(cfg.channels[0], dev)}]
    cin = cfg.channels[0]
    for stage, (n, cout) in enumerate(zip(cfg.stages, cfg.channels)):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            b = {"conv1": _init_conv(gen, 3, cin, cout), "bn1": _init_bn(cout, dev),
                 "conv2": _init_conv(gen, 3, cout, cout), "bn2": _init_bn(cout, dev)}
            if stride != 1 or cin != cout:
                b["proj"] = _init_conv(gen, 1, cin, cout)
                b["proj_bn"] = _init_bn(cout, dev)
            meta.append({"kind": "basic", "stride": stride})
            params.append(b)
            cin = cout
    meta.append({"kind": "head"})
    params.append({"w": torch.randn((cin, cfg.n_classes), generator=gen, device=dev)
                   * cin ** -0.5,
                   "b": torch.zeros((cfg.n_classes,), device=dev)})
    return meta, params


def apply_block(m: dict, b: dict, x: torch.Tensor) -> torch.Tensor:
    kind = m["kind"]
    if kind == "stem":
        return _max_pool(F.relu(_bn(b["bn"], _conv(x, b["conv"], 2))))
    if kind == "basic":
        h = F.relu(_bn(b["bn1"], _conv(x, b["conv1"], m["stride"])))
        h = _bn(b["bn2"], _conv(h, b["conv2"]))
        sc = x
        if "proj" in b:
            sc = _bn(b["proj_bn"], _conv(x, b["proj"], m["stride"]))
        return F.relu(h + sc)
    if kind == "head":
        return x.mean(dim=(1, 2)) @ b["w"] + b["b"]
    raise ValueError(kind)


def forward(meta: List[dict], params: List[dict], x: torch.Tensor,
            upto: Optional[int] = None, start: int = 0) -> torch.Tensor:
    for m, b in zip(meta[start:upto], params[start:upto]):
        x = apply_block(m, b, x)
    return x


def loss_fn(params: List[dict], meta: List[dict], images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(forward(meta, params, images), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def block_costs(cfg: ResNetConfig, meta: List[dict], params: List[dict],
                batch: int) -> List[Tuple[float, float]]:
    """(flops, boundary_bytes) per block for the heterogeneous partitioner.

    boundary_bytes = activation bytes crossing the cut AFTER this block —
    exactly what the paper's USB link had to carry per microbatch.
    """
    out = []
    hw = cfg.img_size // 4                 # after stem
    cin = cfg.channels[0]
    sf = 2 * batch * (cfg.img_size // 2) ** 2 * 7 * 7 * 3 * cfg.channels[0]
    out.append((sf, batch * hw * hw * cin * 4))
    for m, b in zip(meta[1:-1], params[1:-1]):
        cout = b["conv1"].shape[-1]
        if m["stride"] == 2:
            hw //= 2
        f = 2 * batch * hw * hw * 9 * (cin * cout + cout * cout)
        if "proj" in b:
            f += 2 * batch * hw * hw * cin * cout
        out.append((f, batch * hw * hw * cout * 4))
        cin = cout
    out.append((2 * batch * cin * cfg.n_classes, batch * cfg.n_classes * 4))
    return out
