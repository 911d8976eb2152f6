"""Cache backends: the decode-state layout behind one protocol
(port of ``repro/serving/backends.py``, dense layout).

The engine holds one :class:`CacheBackend`, picked by :func:`make_backend`,
and speaks only its verbs: ``token_footprint``, ``fits``, ``prefill_paste``,
``step`` and ``release``.

Only :class:`DenseBackend` (one ``max_len``-wide lane per slot) is ported.
The paged backend with its prefix cache (and the block gauges, reservations,
lane growth and snapshots that come with it) is ROADMAP §1 item 3, the
recurrent one comes with the other families (item 10), and the speculative
verbs (``append_tokens`` / ``verify_step`` / ``rollback``) with speculative
decoding (item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.attention import cache_span


class CacheBackend:
    """Base class: the attributes fleet code reads off every backend
    (``REQUIRED_ATTRS``), at the values of a layout without blocks,
    versioned state or free snapshots."""

    REQUIRED_ATTRS = ("name", "n_blocks", "state_version", "snapshot_free")

    name = "dense"
    n_blocks = 0
    state_version = 0
    snapshot_free = False

    def __init__(self, model: Model, n_lanes: int, max_len: int):
        self.model = model
        self.n_lanes = n_lanes
        self.max_len = max_len


class DenseBackend(CacheBackend):
    """One ``max_len``-wide cache lane per slot.  The cache tensors live on
    the model's device and are updated in place."""

    def __init__(self, model: Model, n_lanes: int, max_len: int):
        super().__init__(model, n_lanes, max_len)
        self._span = cache_span(model.cfg, max_len)
        self.cache = model.init_cache(n_lanes, max_len)

    def token_footprint(self, n_ctx: int, max_new: int) -> int:
        # a lane is max_len wide no matter how short the request is
        return self._span

    def fits(self, n_ctx: int, final_len: int) -> bool:
        """Could a request with this final footprint ever be admitted here?
        Dense lanes admit anything (writes past max_len clamp); capacity
        is the lane count, which the engine bounds."""
        return True

    def prefill_paste(self, slot: int, group_cache: dict, src_lane: int) -> None:
        """Copy lane ``src_lane`` of a prefill cache into decode lane ``slot``."""
        for name in ("k", "v"):
            self.cache["layers"][name][:, slot].copy_(group_cache["layers"][name][:, src_lane])
        self.cache["pos"][slot] = group_cache["pos"][src_lane]

    def step(self, params, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(tokens, dtype=torch.int64).to(self.model.device)
        logits, self.cache = self.model.decode_step(params, self.cache, toks)
        return logits

    def release(self, slot: int) -> None:
        pass                 # lane garbage is overwritten by the next paste


def make_backend(model: Model, n_lanes: int, max_len: int) -> CacheBackend:
    """The backend for ``model``: dense lanes, the only layout ported so far
    (the paged slice adds its choice here, on ``EngineConfig.kv_blocks``)."""
    return DenseBackend(model, n_lanes, max_len)
