"""Logical-axis sharding rules -> partition specs (port of
``repro/core/sharding.py``).

Params get logical axis names derived from their tree path (MaxText-style);
a per-strategy rule table maps logical names to mesh axes.  Rules fall back
to replication when a dimension is not divisible by the mesh axis size,
checked against real shapes, so no emitted spec is invalid.

A spec is a plain tuple of the reference's ``PartitionSpec`` entries: None,
a mesh axis name, or a tuple of names; trailing Nones are trimmed, so a
replicated leaf's spec is ``()``.  Trees are dicts and lists; a spec tuple
is a leaf.

Layouts.  The rules read the reference's layout, where the layer-stacked
entries (``blocks``, and whisper's ``enc_blocks`` / ``dec_blocks``) hold
``(L, ...)`` leaves with a leading "layers" axis (a pipeline's ``(S, lps,
...)`` with "stage" and "layers").  The port keeps ``blocks`` as a list of
per-layer dicts (a pipeline's as S lists of stage slots, pad slots ``{}``):
:func:`reference_layout` stacks such a tree into ``meta`` leaves of the
reference's shapes, the specs are computed there, and each layer's leaf
gets its stacked leaf's spec less the leading entries (the layer, and the
stage, are the leaf's place in the list).  So the specs are the
reference's, ``used`` set and trimming included.

The port runs on one device: nothing here places a tensor.  The specs and
:func:`shard_shape` are what the step builders report and the dry-run
(:mod:`repro_torch.launch.dryrun`) accounts per device.  The activation
hints are the reference's registry, with no setter or reader in the port;
:func:`constrain` returns its input unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# logical axes from tree paths
# ---------------------------------------------------------------------------

# (path-fragment, ndim) -> logical axes per dim.  First match wins.  Leading
# "layers" dims for stacked leaves are added automatically.
_PARAM_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    ("embed/tok",        ("vocab", "embed")),
    ("head/w",           ("embed", "vocab")),
    ("attn/wq",          ("embed", "q")),
    ("attn/wk",          ("embed", "kv")),
    ("attn/wv",          ("embed", "kv")),
    ("attn/wo",          ("q", "embed")),
    ("attn/bq",          ("q",)),
    ("attn/bk",          ("kv",)),
    ("attn/bv",          ("kv",)),
    ("xattn/wq",         ("embed", "q")),
    ("xattn/wk",         ("embed", "kv")),
    ("xattn/wv",         ("embed", "kv")),
    ("xattn/wo",         ("q", "embed")),
    ("moe/router",       ("embed", "experts")),
    ("moe/wi",           ("experts", "embed", "mlp")),
    ("moe/wg",           ("experts", "embed", "mlp")),
    ("moe/wo",           ("experts", "mlp", "embed")),
    ("moe/shared/wi",    ("embed", "mlp")),
    ("moe/shared/wg",    ("embed", "mlp")),
    ("moe/shared/wo",    ("mlp", "embed")),
    ("mlp/wi",           ("embed", "mlp")),
    ("mlp/wg",           ("embed", "mlp")),
    ("mlp/wo",           ("mlp", "embed")),
    ("mamba/in_proj",    ("embed", "ssm_in")),
    ("mamba/out_proj",   ("ssm_in", "embed")),
    ("mamba/conv_w",     (None, "ssm_conv")),
    ("mamba/conv_b",     ("ssm_conv",)),
    ("rwkv/wr",          ("embed", "q")),
    ("rwkv/wk",          ("embed", "q")),
    ("rwkv/wv",          ("embed", "q")),
    ("rwkv/wg",          ("embed", "q")),
    ("rwkv/wo",          ("q", "embed")),
    ("rwkv/ck",          ("embed", "mlp")),
    ("rwkv/cv",          ("mlp", "embed")),
    ("rwkv/cr",          ("embed", "q")),
    ("rwkv/w_lora_a",    ("embed", None)),
    ("rwkv/w_lora_b",    (None, "embed")),
)

# strategy -> {logical axis: mesh axis}
RULE_TABLES: Dict[str, Dict[str, Any]] = {
    # TP over "model", optional FSDP over "data" on the "embed" dim.
    "gspmd_tp": {
        "vocab": "model", "q": "model", "kv": "model", "mlp": "model",
        "experts": "model", "ssm_in": "model", "ssm_conv": "model",
        "embed": None,           # flipped to "data" when fsdp=True
        "layers": None,
    },
    # stacked-stage pipeline: stage axis on "data", TP on "model".
    "gspmd_pp": {
        "stage": "data",
        "vocab": "model", "q": "model", "kv": "model", "mlp": "model",
        "experts": "model", "ssm_in": "model", "ssm_conv": "model",
        "embed": None, "layers": None,
    },
}

STACKED = ("blocks", "enc_blocks", "dec_blocks")


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists; the path joins the
    dict keys and list indices with "/" (the reference's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def logical_axes_for(path: str, ndim: int,
                     leading: Tuple[Optional[str], ...] = ()) -> Tuple:
    """Logical axes for one param leaf; unknown leaves replicate."""
    for frag, axes in _PARAM_RULES:
        if path.endswith(frag) or (frag + "/") in path or ("/" + frag) in path:
            want = len(axes) + len(leading)
            if ndim == want:
                return tuple(leading) + tuple(axes)
            if ndim == len(axes):
                return tuple(axes)
            # stacked with extra leading dims (e.g. experts handled in rule)
            extra = ndim - len(axes)
            if extra > 0:
                return tuple(leading[:extra]) + (None,) * max(0, extra - len(leading)) + tuple(axes)
    return (None,) * ndim


def param_logical_tree(params: Any, stacked_prefix: str = "blocks",
                       leading: Tuple[Optional[str], ...] = ("layers",)) -> Any:
    """Tree of logical-axis tuples matching ``params`` (the reference's
    layout).  Leaves under ``stacked_prefix`` (or ``enc_blocks`` /
    ``dec_blocks``) get the ``leading`` axes prepended."""
    def fn(p, leaf):
        stacked = any(p.startswith(pref) for pref in
                      (stacked_prefix, "enc_blocks", "dec_blocks"))
        return logical_axes_for(p, leaf.dim(), leading if stacked else ())

    return map_with_path(fn, params)


def _axes(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _entry(axes: Tuple[str, ...]):
    """One spec entry over ``axes``: a lone axis by its name, as
    ``PartitionSpec`` keeps it."""
    return axes[0] if len(axes) == 1 else axes


def data_entry(mesh):
    """The spec entry of the batch dim: the data axes present ("pod",
    "data")."""
    return _entry(tuple(a for a in ("pod", "data") if a in mesh.shape))


def spec_for(logical: Tuple, shape: Sequence[int], rules: Dict[str, Any], mesh) -> Spec:
    """Spec from logical axes; replicates non-divisible dims."""
    out = []
    used = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if axis is None or axis in used:
            out.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in _axes(axis))
        if dim % int(size) == 0:
            out.append(axis)
            used.add(axis)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A leaf's per-device shard shape under ``spec`` on ``mesh`` (the
    reference's ``NamedSharding(mesh, spec).shard_shape``)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= math.prod(mesh.shape[a] for a in _axes(entry))
    return tuple(out)


def shard_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` under the spec tree ``specs``."""
    total = 0

    def add(path, leaf):
        nonlocal total
        spec = _at(specs, path)
        total += math.prod(shard_shape(leaf.shape, spec, mesh)) * leaf.element_size()

    map_with_path(add, tree)
    return total


def _at(tree: Any, path: str) -> Any:
    for part in path.split("/") if path else ():
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# ---------------------------------------------------------------------------
# the port's layouts <-> the reference's
# ---------------------------------------------------------------------------

def _leading(entry) -> int:
    """Leading stacked dims the reference gives a stacked entry held in the
    port's layout: 1 for a list of layer dicts, 2 for a pipeline's list of
    stage-slot lists, 0 for an entry already stacked."""
    if isinstance(entry, list):
        return 2 if entry and isinstance(entry[0], list) else 1
    return 0


def _stack_shapes(items: list) -> Any:
    """``meta`` leaves of shape ``(len(items),) + leaf.shape`` over a list of
    trees of one structure; ``{}`` pad slots count as slots."""
    template = next(it for it in items if it != {})
    if isinstance(template, list):
        template = _stack_shapes(template)

    def fn(_, leaf):
        return torch.empty((len(items),) + tuple(leaf.shape), dtype=leaf.dtype, device="meta")

    return map_with_path(fn, template)


def reference_layout(params: dict) -> dict:
    """``params`` with each stacked entry held in the port's layout turned
    into ``meta`` leaves of the reference's stacked shapes: ``(L, ...)`` for
    a list of layers, ``(S, lps, ...)`` for a pipeline's stage slots (pad
    slots included, as the reference stacks zeros for them).  Other entries
    are kept as they are."""
    out = dict(params)
    for name in STACKED:
        if name in params and _leading(params[name]):
            out[name] = _stack_shapes(params[name])
    return out


def to_port_layout(params: dict, specs: dict) -> dict:
    """The reference layout's ``specs`` onto ``params``' layout: each leaf of
    a stacked entry held as a list takes its stacked leaf's spec less the
    leading stacked entries."""
    out = dict(specs)
    for name in STACKED:
        n = _leading(params.get(name))
        if not n:
            continue
        per_leaf = map_with_path(lambda _, s: s[n:], specs[name])

        def place(tree, depth):
            if depth:
                return [place(t, depth - 1) for t in tree]
            return map_with_path(lambda p, _: _at(per_leaf, p), tree)

        out[name] = place(params[name], n)
    return out


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def reference_shardings(params: Any, mesh, strategy: str,
                        fsdp: bool = False) -> Tuple[dict, Any]:
    """(``reference_layout(params)``, its spec tree): the reference's
    ``param_shardings`` on its own layout.  A pipeline's stage slots take
    the leading axes ("stage", "layers"), every other stacked entry
    ("layers",)."""
    rules = dict(RULE_TABLES[strategy])
    if fsdp:
        rules["embed"] = "data"
    ref = reference_layout(params)
    leading = ("stage", "layers") if _leading(params.get("blocks")) == 2 else ("layers",)
    logical = param_logical_tree(ref, leading=leading)
    return ref, map_with_path(
        lambda p, leaf: spec_for(_at(logical, p), leaf.shape, rules, mesh), ref)


def param_shardings(params: Any, mesh, strategy: str, fsdp: bool = False) -> Any:
    """Spec tree for a params tree (tensors of any device, ``meta`` included),
    in the tree's own layout (:func:`reference_shardings` mapped back)."""
    return to_port_layout(params, reference_shardings(params, mesh, strategy, fsdp)[1])


def pp_shardmap_shardings(params: dict, mesh) -> Tuple[dict, Any, Any]:
    """pp_shardmap's rule for a stage-slot params tree, on the reference's
    layout: (params, params' specs, moments' specs).  The reference holds
    the stage slots as ``(model_axis, lps, ...)`` (each replica column a
    copy of its stage) with P("model") on dim 0 and replicates the other
    leaves; their moments are ZeRO-sharded over "model" on dim 0 where it
    divides."""
    msize = mesh.shape["model"]
    ref = reference_layout(params)
    ref["blocks"] = map_with_path(
        lambda _, t: torch.empty((msize,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta"),
        ref["blocks"])
    p_spec = map_with_path(lambda p, _: ("model",) if p.startswith("blocks") else (), ref)
    m_spec = map_with_path(
        lambda p, t: ("model",) if p.startswith("blocks") or (
            t.dim() and t.shape[0] % msize == 0) else (), ref)
    return ref, p_spec, m_spec


def batch_shardings(batch_specs: Any, mesh,
                    batch_axes: Tuple[str, ...] = ("pod", "data")) -> Any:
    """Shard dim 0 (batch) of every input over the data axes present."""
    axes = tuple(a for a in batch_axes if a in mesh.shape)
    dp = math.prod(mesh.shape[a] for a in axes)

    def fn(_, leaf):
        if leaf.dim() == 0:
            return ()
        return (_entry(axes),) if leaf.shape[0] % dp == 0 else ()

    return map_with_path(fn, batch_specs)


def cache_shardings(cache_specs: Any, mesh, cfg=None) -> Any:
    """KV caches: layer dim replicated, batch dim over the data axes, the
    largest trailing dim divisible by "model" over it.  Cache leaves are
    (L, B, ...)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = math.prod(mesh.shape[a] for a in axes)
    tp = mesh.shape.get("model", 1)

    def fn(_, leaf):
        nd = leaf.dim()
        if nd < 2:
            return ()
        spec: list = [None] * nd
        bdim = 1
        if leaf.shape[bdim] % dp == 0 and leaf.shape[bdim] > 0:
            spec[bdim] = _entry(axes)
        best, best_size = None, 0
        for i in range(bdim + 1, nd):
            if leaf.shape[i] % tp == 0 and leaf.shape[i] > best_size and leaf.shape[i] >= tp:
                best, best_size = i, leaf.shape[i]
        if best is not None:
            spec[best] = "model"
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return map_with_path(fn, cache_specs)


# ---------------------------------------------------------------------------
# activation sharding hints (set by the step builders)
# ---------------------------------------------------------------------------

_ACT_HINTS: Dict[str, Any] = {}


def set_activation_hints(**kw) -> None:
    """Register specs for named activation sites (e.g. "residual"), the
    reference's API.  No builder of the port sets one (a ``seq_shard``
    build raises) and its model code does not call :func:`constrain`."""
    _ACT_HINTS.update(kw)


def clear_activation_hints() -> None:
    _ACT_HINTS.clear()


def constrain(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is: on the one device every spec is met already."""
    return x
