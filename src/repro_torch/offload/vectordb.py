"""Mock vector database (paper §3.6), a numpy copy of
``repro/offload/vectordb.py``: dot-product top-k over a synthetic document
embedding matrix (stand-in for the 100k AG-News x all-MiniLM-L6-v2 corpus
the paper used).  It stands in for the iOS worker's search and stays on the
host.

``encode`` seeds from Python's ``hash()`` of the query, as the reference
does: the same query maps to the same vector within one process, and to
another one in another process unless ``PYTHONHASHSEED`` is fixed."""

from __future__ import annotations

import numpy as np


class VectorDB:
    def __init__(self, n_docs: int = 100_000, dim: int = 384, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.embeddings = rng.standard_normal((n_docs, dim)).astype(np.float32)
        self.embeddings /= np.linalg.norm(self.embeddings, axis=1, keepdims=True)
        self.dim = dim

    def encode(self, query: str) -> np.ndarray:
        """Mock text encoder, deterministic within one process."""
        rng = np.random.default_rng(abs(hash(query)) % (2 ** 32))
        v = rng.standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def search(self, query_vec: np.ndarray, k: int = 5) -> np.ndarray:
        """Returns (k, 2) array of [doc_id, score] — the paper's tool output."""
        scores = self.embeddings @ np.asarray(query_vec, np.float32).ravel()
        idx = np.argpartition(scores, -k)[-k:]
        idx = idx[np.argsort(-scores[idx])]
        return np.stack([idx.astype(np.float32), scores[idx]], axis=1)

    def search_text(self, query: str, k: int = 5) -> np.ndarray:
        return self.search(self.encode(query), k)
