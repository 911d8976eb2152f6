"""Deterministic synthetic data (port of ``repro/data/synthetic.py``: the
token stream and the image batches of the ResNet reproduction).

A fixed random bigram transition table gives the stream learnable
structure, so training loss measurably descends (a uniform stream would
plateau at ln(V)).  numpy throughout, with the reference's generators and
draw order: the same (seed, step, shard) gives the reference's batch, bit
for bit.  Image batches are class-templated noise (paper §4.1).  The
frontend pipeline waits for its families (ROADMAP §1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8          # bigram successors per token (entropy ~ln(8))


class TokenPipeline:
    """Bigram-structured token stream, shardable and seekable."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not split into "
                             f"{n_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        rng = np.random.default_rng(cfg.seed)
        # fixed transition table: token t may be followed by branching tokens
        self.table = rng.integers(0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching),
                                  dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // self.n_shards
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 64 + self.shard)
        toks = np.empty((b, cfg.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, cfg.branching, size=(b, cfg.seq_len - 1))
        for t in range(1, cfg.seq_len):
            toks[:, t] = self.table[toks[:, t - 1], choices[:, t - 1]]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class ImagePipeline:
    """Class-templated noisy images (ResNet §4.1 reproduction), NHWC float32
    with int32 labels."""

    def __init__(self, n_classes: int, img_size: int, batch: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1):
        self.n_classes = n_classes
        self.img = img_size
        self.batch = batch // n_shards
        self.seed = seed
        self.shard = shard
        rng = np.random.default_rng(seed)
        self.templates = rng.standard_normal(
            (n_classes, img_size, img_size, 3)).astype(np.float32)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed + step) * 64 + self.shard)
        labels = rng.integers(0, self.n_classes, size=self.batch)
        x = self.templates[labels] + 0.5 * rng.standard_normal(
            (self.batch, self.img, self.img, 3)).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int32)
