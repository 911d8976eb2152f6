"""Model protocol (port of ``repro/models/api.py``).

    model = build_model(cfg, rcfg, device="cuda")
    params = model.init(seed)
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens)
    loss, aux = model.loss(params, batch)

Every ported family (dense, rwkv, hybrid) trains and serves.
``model.decode_state`` (a :class:`DecodeState`) tells the serving backends
what the decode state supports; ``batched_prefill`` is set only where
right-padding is provably inert (full causal attention), and the block-pool
pair ``pool_init`` / ``pool_step`` only where the decode state is a
position-addressed K/V cache (full attention).  rwkv and zamba2 carry a
recurrent state: each request is prefilled alone at its exact length, and
the ``RecurrentBackend`` serves them.

The dense family also serves layer-split: :func:`stage_model` is a Model
over one layer range, and :func:`split_stage_params` cuts the params to
match (pipeline-split serving, paper §4.1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import leaves
from repro_torch.models import lm as LM
from repro_torch.models.blocks import is_recurrent, require_ported


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """``kind`` is the state taxonomy ("attention" for the dense family,
    "recurrent" for rwkv and zamba2: a constant-size state per lane,
    cheap to snapshot and restore);
    ``batched_prefill(params, batch, lengths, max_len)`` is the
    right-padded bucketed prefill, or None where padding would leak.

    ``pool_init(n_lanes, n_blocks, block_size)`` / ``pool_step(params,
    cache, tokens, block_tables)`` are the paged layout's cache constructor
    and decode step (:func:`repro_torch.models.lm.init_pool_cache` /
    :func:`~repro_torch.models.lm.lm_decode_step_pool`); ``poolable`` says
    whether they exist."""

    kind: str
    batched_prefill: Optional[
        Callable[[dict, Dict[str, torch.Tensor], torch.Tensor, int],
                 Tuple[torch.Tensor, dict]]] = None
    pool_init: Optional[Callable[[int, int, int], dict]] = None
    pool_step: Optional[
        Callable[[dict, dict, torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, dict]]] = None

    @property
    def poolable(self) -> bool:
        return self.pool_step is not None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rcfg: RunConfig
    device: torch.device
    init: Callable[[int], dict]
    loss: Callable[..., Tuple[torch.Tensor, dict]]
    prefill: Callable[[dict, Dict[str, torch.Tensor], int], Tuple[torch.Tensor, dict]]
    decode_step: Callable[[dict, dict, torch.Tensor], Tuple[torch.Tensor, dict]]
    init_cache: Callable[[int, int], dict]
    decode_state: DecodeState = DecodeState(kind="attention")


def build_model(cfg: ModelConfig, rcfg: RunConfig, device="cuda") -> Model:
    """The model's entry points on ``device`` (default ``cuda``).

    Dense decoder LMs, rwkv6 and zamba2 train and serve; other families
    raise naming their ROADMAP item.  Params and compute share one dtype
    here."""
    require_ported(cfg)
    if rcfg.param_dtype != rcfg.compute_dtype:
        raise ValueError(f"repro_torch runs with param_dtype == compute_dtype, got "
                         f"{rcfg.param_dtype!r} and {rcfg.compute_dtype!r}")
    device = torch.device(device)
    dt = LM.dtype_of(rcfg.param_dtype)

    def init(seed: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(seed)
        return LM.init_lm(cfg, gen, dt)

    # right-padded batched prefill and the block pool are both exact only
    # for full causal attention (the reference's ragged_ok / pool_ok gates,
    # restricted to the families the port builds): recurrent state folds
    # pad tokens in and is not position-addressed; chunked_local's ring
    # buffer is dense-span specific
    recurrent = is_recurrent(cfg)
    batched = pool_init = pool_step = None
    if cfg.attention == "full" and not recurrent:
        def batched(p, b, ln, ml):
            return LM.lm_prefill_padded(cfg, p, b, ln, rcfg, ml)

        def pool_init(nl, nb, bs):
            return LM.init_pool_cache(cfg, nl, nb, bs, dt, device)

        def pool_step(p, c, t, bt):
            return LM.lm_decode_step_pool(cfg, p, c, t, bt, rcfg)

    return Model(
        cfg=cfg, rcfg=rcfg, device=device,
        init=init,
        loss=lambda p, b: LM.lm_loss(cfg, p, b, rcfg),
        prefill=lambda p, b, ml: LM.lm_prefill(cfg, p, b, rcfg, ml),
        decode_step=lambda p, c, t: LM.lm_decode_step(cfg, p, c, t, rcfg),
        init_cache=lambda bsz, ml: LM.init_cache(cfg, bsz, ml, dt, device),
        decode_state=DecodeState(kind="recurrent" if recurrent else "attention",
                                 batched_prefill=batched, pool_init=pool_init,
                                 pool_step=pool_step),
    )


# ---------------------------------------------------------------------------
# layer-range stage models (pipeline-split serving, paper §4.1 topology)
# ---------------------------------------------------------------------------

def stage_eligible(cfg: ModelConfig) -> bool:
    """Can this family's layers be cut into self-contained stages?

    A stage is exact iff nothing couples layers across the cut: dense and
    moe qualify (per-layer attention KV + per-token routing); excluded are
    rwkv/ssm/hybrid (the zamba2 SHARED attention block fires across the
    whole depth; recurrent state would work layer-wise but the serving
    backends treat it whole), enc-dec (cross-attention keyed to one
    encoder pass) and frontend configs (the embedding concat is a
    first-stage-only input the stage protocol doesn't carry)."""
    return (cfg.family in ("dense", "moe") and not cfg.rwkv
            and not cfg.n_enc_layers and not cfg.frontend)


def _stage_stub(what: str):
    def stub(*_a, **_k):
        raise RuntimeError(
            f"stage models hold one layer slice of a split model; {what} "
            f"belongs to the full model (build_model)")
    return stub


@functools.lru_cache(maxsize=128)
def stage_model(model: Model, lo: int, hi: int) -> Model:
    """A Model executing only layers [lo, hi) of ``model``, on its device.

    Its ``prefill`` takes ``{"tokens"}`` on the first stage and
    ``{"hidden"}`` (the previous stage's boundary activations) otherwise;
    its ``decode_step`` input is tokens (B, 1) or hidden (B, 1, D) the
    same way.  Non-last stages OUTPUT the boundary hidden instead of
    logits.  Params are the slice produced by :func:`split_stage_params`.

    ``init_cache`` covers exactly the slice's layers, so a serving
    backend instantiates per stage over the layer range: stage 0 owns the
    low-layer KV, stage 1 the rest.  Cached (lru), so every engine serving
    the same cut shares one Model object.
    """
    cfg, rcfg = model.cfg, model.rcfg
    if not stage_eligible(cfg):
        raise ValueError(
            f"family {cfg.family!r} (rwkv={cfg.rwkv}) cannot be layer-split "
            f"into serving stages")
    if not (0 <= lo < hi <= cfg.n_layers):
        raise ValueError(f"bad stage range [{lo}, {hi}) for "
                         f"{cfg.n_layers} layers")
    first, last = lo == 0, hi == cfg.n_layers
    scfg = dataclasses.replace(cfg, n_layers=hi - lo)
    cdt = LM.dtype_of(rcfg.compute_dtype)
    device = model.device
    return Model(
        cfg=scfg, rcfg=rcfg, device=device,
        init=_stage_stub("init"),
        loss=_stage_stub("loss"),
        prefill=lambda p, b, ml: LM.lm_stage_prefill(
            scfg, p, b, rcfg, ml, first=first, last=last),
        decode_step=lambda p, c, t: LM.lm_stage_decode_step(
            scfg, p, c, t, rcfg, first=first, last=last),
        init_cache=lambda bsz, ml: LM.init_cache(scfg, bsz, ml, cdt, device),
        decode_state=DecodeState(kind="attention"),
    )


def split_stage_params(model: Model, params: dict,
                       cuts: Sequence[int]) -> List[dict]:
    """Slice a full param tree into per-stage trees for ``cuts``.

    Stage i holds ``blocks[bounds[i]:bounds[i+1]]`` (a slice of the list of
    per-layer dicts, sharing their tensors); the first stage adds the
    embedding table, the last adds the final norm and the head.  For tied
    embeddings the last stage holds the table too (a real deployment ships
    it to both ends of the wire, and :func:`param_bytes` charges it on
    both).  No stage refers to the full tree, so callers may drop it and
    the layers no stage holds are freed: the memory-wall point of the
    split."""
    n = model.cfg.n_layers
    bounds = (0,) + tuple(cuts) + (n,)
    if list(bounds) != sorted(set(bounds)):
        raise ValueError(f"cuts {cuts!r} not strictly increasing in (0, {n})")
    out: List[dict] = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        p = {"blocks": params["blocks"][lo:hi]}
        if i == 0:
            p["embed"] = params["embed"]
        if hi == n:
            p["final_ln"] = params["final_ln"]
            if model.cfg.tie_embeddings:
                p.setdefault("embed", params["embed"])
            else:
                p["head"] = params["head"]
        out.append(p)
    return out


def param_bytes(tree: Any) -> int:
    """Total bytes of a param (sub)tree's tensors: stage memory accounting.
    A tensor held twice in the tree is counted twice."""
    return int(sum(t.numel() * t.element_size() for t in leaves(tree)))
