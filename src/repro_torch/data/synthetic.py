"""Deterministic synthetic data (port of ``repro/data/synthetic.py``: the
token stream, its frontend variant and the image batches of the ResNet
reproduction).

A fixed random bigram transition table gives the stream learnable
structure, so training loss measurably descends (a uniform stream would
plateau at ln(V)).  numpy throughout, with the reference's generators and
draw order: the same (seed, step, shard) gives the reference's batch, bit
for bit.  :class:`FrontendPipeline` adds the stubbed frontends' rows
(internvl2's patches under ``"frontend"``, whisper's frames under
``"frames"``).  Image batches are class-templated noise (paper §4.1).
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


class FrontendPipeline(TokenPipeline):
    """Adds stub frame/patch embeddings (the [audio]/[vlm] frontends): float32
    (B, ``frontend_seq``, ``d_model``) rows of 0.1 x a standard normal under
    ``key``, from their own generator of (seed, step, shard)."""

    def __init__(self, cfg: DataConfig, frontend_seq: int, d_model: int,
                 key: str = "frontend", shard: int = 0, n_shards: int = 1):
        super().__init__(cfg, shard, n_shards)
        self.frontend_seq = frontend_seq
        self.d_model = d_model
        self.key = key

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        out = super().batch(step)
        b = out["tokens"].shape[0]
        rng = np.random.default_rng((self.cfg.seed * 7_000_003 + step) * 64 + self.shard + 17)
        out[self.key] = (0.1 * rng.standard_normal(
            (b, self.frontend_seq, self.d_model))).astype(np.float32)
        return out


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
