"""Token sampling for the serving engine (port of ``repro/serving/sampling.py``).

Per-request :class:`SamplingParams` are flattened into per-lane arrays
(temperature / top-k / top-p / key) so one :meth:`Sampler.sample` call
serves every active lane of the continuous batch; greedy and stochastic
lanes coexist in one call.

Semantics (as the reference):

* ``temperature <= 0``  -> greedy argmax; the lane's stream is not consumed.
* ``top_k > 0``         -> restrict to the k highest logits.
* ``top_p < 1``         -> restrict to the smallest prefix of the
  probability-sorted vocab whose cumulative mass reaches ``top_p`` (the
  boundary token is kept), over the renormalised top-k survivors.

Each lane's key is ``(seed, counter)``: draw ``counter`` of request ``seed``
seeds a ``torch.Generator`` on the logits' device, which draws the Gumbel
noise of that one draw there (no host work beyond the seed).  On one device
a request's tokens therefore depend only on its seed, its draw count and its
logits -- never on lane placement or batch composition -- and preempt/resume
keeps the stream by carrying the key (``Request.saved_key``).  The CPU and
CUDA generators draw different bits for one seed, and neither draws the
reference's threefry bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.  Defaults reproduce the greedy engine."""
    temperature: float = 0.0
    top_k: int = 0                 # 0 = disabled
    top_p: float = 1.0             # 1 = disabled
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass
class LaneSampling:
    """SoA view of the sampling state of every lane (host side)."""
    temperature: np.ndarray        # (B,) float32
    top_k: np.ndarray              # (B,) int32
    top_p: np.ndarray              # (B,) float32
    key: np.ndarray                # (B, 2) int64: (seed, draws taken)

    @classmethod
    def empty(cls, n_lanes: int) -> "LaneSampling":
        return cls(temperature=np.zeros((n_lanes,), np.float32),
                   top_k=np.zeros((n_lanes,), np.int32),
                   top_p=np.ones((n_lanes,), np.float32),
                   key=np.zeros((n_lanes, 2), np.int64))

    def set_lane(self, lane: int, params: SamplingParams) -> None:
        self.temperature[lane] = params.temperature
        self.top_k[lane] = params.top_k
        self.top_p[lane] = params.top_p
        self.key[lane] = (params.seed, 0)

    def clear_lane(self, lane: int) -> None:
        self.set_lane(lane, GREEDY)


def _filter_one(logits: torch.Tensor, temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
    """Temperature-scale then top-k/top-p mask one lane's logits (V,)."""
    v = logits.shape[-1]
    dev = logits.device
    t = torch.tensor(max(float(np.float32(temperature)), 1e-6), dtype=torch.float32)
    scaled = logits.float() / t.to(dev)
    order = torch.sort(scaled, descending=True).values
    # top-k threshold: value of the k-th largest logit (k == 0 -> whole vocab)
    k = int(top_k) if top_k > 0 else v
    in_topk = torch.arange(v, device=dev) < k
    kth = order[min(max(k - 1, 0), v - 1)]
    # top-p over the renormalised top-k survivors: keep entries whose
    # preceding cumulative survivor mass is < top_p (boundary included)
    probs = torch.softmax(torch.where(in_topk, order, torch.tensor(NEG_INF, device=dev)), -1)
    prior_mass = torch.cumsum(probs, -1) - probs
    in_nucleus = in_topk & (prior_mass < torch.tensor(np.float32(top_p), device=dev))
    pth = torch.where(in_nucleus, order, torch.tensor(float("inf"), device=dev)).min()
    cut = torch.maximum(kth, pth)
    return torch.where(scaled < cut, torch.tensor(NEG_INF, device=dev), scaled)


def _draw_seed(seed: int, counter: int) -> int:
    """splitmix64 of (seed, counter): the generator seed of one draw."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(counter) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _gumbel(seed: int, counter: int, v: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(_draw_seed(seed, counter))
    u = torch.rand((v,), generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class Sampler:
    """Owns the per-lane filter + key state (``.lanes``) and both sampling
    entry points: the plain engine's one-token :meth:`sample` and the
    speculative engine's window :meth:`accept` share this object, so the
    speculative path keeps the plain engine's discipline."""

    def __init__(self, n_lanes: int):
        self.n_lanes = n_lanes
        self.lanes = LaneSampling.empty(n_lanes)

    def set_lane(self, lane: int, params: SamplingParams) -> None:
        self.lanes.set_lane(lane, params)

    def clear_lane(self, lane: int) -> None:
        self.lanes.clear_lane(lane)

    def copy_state_from(self, other: "Sampler") -> None:
        """Adopt ``other``'s full lane state (filters + keys): the draft
        sampler mirrors the target's at the start of every speculative
        round, so a perfectly aligned draft proposes exactly what the
        target will sample."""
        np.copyto(self.lanes.temperature, other.lanes.temperature)
        np.copyto(self.lanes.top_k, other.lanes.top_k)
        np.copyto(self.lanes.top_p, other.lanes.top_p)
        np.copyto(self.lanes.key, other.lanes.key)

    def sample(self, logits: torch.Tensor, lanes: Optional[Sequence[int]] = None,
               mask: Optional[np.ndarray] = None) -> np.ndarray:
        """One token per row of ``logits`` (R, V); ``lanes`` maps rows to
        lane indices (default: row i is lane i).  ``mask`` (R,) freezes the
        keys of masked-out rows, whose tokens are garbage.  One host
        transfer."""
        ls = self.lanes
        idx = np.arange(logits.shape[0]) if lanes is None else np.asarray(lanes)
        toks = torch.argmax(logits, dim=-1)
        for row, lane in enumerate(idx.tolist()):
            if ls.temperature[lane] <= 0.0 or (mask is not None and not mask[row]):
                continue
            seed, counter = (int(x) for x in ls.key[lane])
            filt = _filter_one(logits[row], ls.temperature[lane], int(ls.top_k[lane]),
                               ls.top_p[lane])
            noise = _gumbel(seed, counter, logits.shape[-1], logits.device)
            toks[row] = torch.argmax(filt + noise)
            ls.key[lane, 1] = counter + 1
        return toks.to(torch.int32).cpu().numpy()

    def accept(self, window_logits: torch.Tensor, drafted: np.ndarray, active: np.ndarray,
               limit: Sequence[int], eos_id: Optional[int] = None
               ) -> Tuple[List[List[int]], np.ndarray, np.ndarray]:
        """Coupled acceptance over one verify window.

        ``window_logits`` (B, W, V) are the target's logits after each of the
        W = k + 1 window tokens, on the device they were computed on (a
        stochastic draw there uses that device's generator, as
        :meth:`sample` does in the plain engine); ``drafted`` (B, k) the
        draft's proposals; ``active`` (B,) the lanes that ran the round;
        ``limit`` (B,) the tokens each lane may still emit; ``eos_id`` ends a
        lane.

        Position j's logits are sampled through the lane's own stream --
        exactly the token the plain engine would emit next -- and the lane
        continues past j iff that token equals ``drafted[:, j]``.  The draft
        decides only how far a round reaches, never what is emitted, and a
        lane takes one draw per emitted token (masked sampling), so the
        stream equals the plain engine's for greedy and stochastic lanes.

        Returns (per-lane emitted tokens, n_emitted (B,), n_accepted (B,)
        drafted tokens matched)."""
        b, w = window_logits.shape[:2]
        k = w - 1
        alive = np.asarray(active, bool).copy()
        emitted: List[List[int]] = [[] for _ in range(b)]
        n_acc = np.zeros(b, np.int64)
        limit = np.asarray(limit)
        for j in range(w):
            if not alive.any():
                break
            toks = self.sample(window_logits[:, j], mask=alive)
            for i in range(b):
                if not alive[i]:
                    continue
                t = int(toks[i])
                emitted[i].append(t)
                done = len(emitted[i]) >= limit[i] or (eos_id is not None and t == eos_id)
                # a drafted token the target also sampled is accepted even
                # when the lane ends here (limit or eos): done controls
                # continuation, not the proposal's correctness
                if j < k and t == int(drafted[i, j]):
                    n_acc[i] += 1
                if j == k or done or t != int(drafted[i, j]):
                    alive[i] = False
        n_emitted = np.array([len(e) for e in emitted], np.int64)
        return emitted, n_emitted, n_acc
