"""Parameters and decode caches from the JAX package's layout into the port's.

``params_from_jax`` takes the reference's param tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the
port's tree: the ``(L, ...)`` stacked block leaves are cut into one dict
per layer, and bf16 leaves (ml_dtypes arrays) cross as a ``uint16`` bit
view reinterpreted as ``torch.bfloat16``, so no value is rounded.
``cache_from_jax`` carries a decode cache the same way; the port keeps the
reference's cache tree (layer-stacked leaves, ``pos``, zamba2's
``ak``/``av``), so every leaf crosses as it is.  ``resnet_params_from_jax``
carries ResNet-34's list of block dicts, whose layout the port keeps too.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def move_params(tree: Any, device) -> Any:
    """Every tensor of ``tree`` copied to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def leaves(tree: Any):
    """The leaves of a tree of dicts, lists and tuples, in the order
    ``jax.tree.leaves`` gives them: dicts by sorted key, sequences in order.
    Two trees of one structure give their leaves in the same order, however
    their dicts were built."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def unflatten(like: Any, values) -> Any:
    """A tree of ``like``'s structure whose leaves are ``values``, taken in
    :func:`leaves` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def params_from_jax(tree: dict, device="cuda") -> dict:
    out = {}
    for name, sub in tree.items():
        if name == "blocks":
            n = next(iter(leaves(sub))).shape[0]
            out[name] = [tree_map(lambda a, i=i: tensor_from_numpy(a[i]).to(device), sub)
                         for i in range(n)]
        else:
            out[name] = tree_map(lambda a: tensor_from_numpy(a).to(device), sub)
    return out


def cache_from_jax(tree: dict, device="cuda") -> dict:
    """A JAX decode cache with numpy leaves as the port's cache on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a).to(device), tree)


def resnet_params_from_jax(blocks: List[dict], device="cuda") -> List[dict]:
    """The reference's ResNet block list with numpy leaves as the port's, on
    ``device``: the layout is the same, so each leaf crosses as it is."""
    return cache_from_jax(blocks, device)


def stack_blocks(tree: dict) -> dict:
    """The port's params (or a tree of their shape) in the reference's
    layout: the per-layer block dicts stacked into ``(L, ...)`` leaves.
    Other entries are kept as they are.  Wire frames of a model tree
    (the fed plane's updates) are built in this layout, so a frame from
    either package decodes in the other onto the same tree."""
    blocks = tree["blocks"]
    stacked = unflatten(blocks[0], [torch.stack(ls) for ls in
                                    zip(*(list(leaves(b)) for b in blocks))])
    return {**tree, "blocks": stacked}


def unstack_blocks(tree: dict) -> dict:
    """:func:`stack_blocks`' inverse: ``(L, ...)`` block leaves cut into one
    dict per layer (views of the stacked leaves)."""
    sub = tree["blocks"]
    n = next(iter(leaves(sub))).shape[0]
    return {**tree, "blocks": [tree_map(lambda a, i=i: a[i], sub) for i in range(n)]}
