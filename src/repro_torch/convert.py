"""Parameters from the JAX package's layout into the port's.

``params_from_jax`` takes the reference's param tree with numpy leaves
(``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the
port's tree: the ``(L, ...)`` stacked block leaves are cut into one dict
per layer, and bf16 leaves (ml_dtypes arrays) cross as a ``uint16`` bit
view reinterpreted as ``torch.bfloat16``, so no value is rounded.
"""

from __future__ import annotations

from typing import Any

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
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


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
