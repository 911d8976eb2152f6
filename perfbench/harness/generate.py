"""The one traffic generator: it reads a mix's parameters (a JSON file under
``traffic/``) and draws every prompt from the run's seed.

Sizes are stratified: a block of ``n`` draws holds the ``n`` quantiles
``(i + 0.5) / n`` of the stated distribution, and the seed only orders
them.  Every seed therefore offers the same set of sizes, and every prefix
of whole blocks the same work, in another order; token ids are drawn freely
from the seed.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of the seed per use, so that adding a draw to
    one part of a mix moves nothing in another."""
    return np.random.default_rng([seed, *stream.encode()])


def quantile(spec: Dict, q: np.ndarray) -> np.ndarray:
    """The distribution ``spec`` evaluated at quantiles ``q`` in (0, 1)."""
    kind = spec["dist"]
    lo, hi = spec.get("min"), spec.get("max")
    if kind == "uniform":
        x = lo + q * (hi - lo)
    elif kind == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif kind == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(float(p)) for p in q])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    x = np.rint(x)
    if lo is not None:
        x = np.clip(x, lo, hi)
    return x.astype(np.int64)


def stratified(spec: Dict, n: int, block: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` draws of ``spec``: whole blocks of ``block`` quantiles, each
    block in its own seeded order."""
    q = (np.arange(block) + 0.5) / block
    base = quantile(spec, q)
    out = [base[rng.permutation(block)] for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]


def tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32)


@dataclasses.dataclass
class Offline:
    prompts: List[np.ndarray]
    max_new: List[int]


def offline(mix: Dict, seed: int, vocab: int) -> Offline:
    """A queue of unique prompts, all due at the window's start."""
    n, block = mix["requests"], mix["block"]
    lens = stratified(mix["prompt"], n, block, rng_for(seed, "prompt"))
    outs = stratified(mix["max_new"], n, block, rng_for(seed, "max_new"))
    ids = rng_for(seed, "tokens")
    return Offline([tokens(ids, int(t), vocab) for t in lens], [int(m) for m in outs])
