"""The paper's technique: pipeline-parallel training over the "model" mesh
axis (port of ``repro/core/pipeline.py``).

Layout: the "model" axis hosts S pipeline stages x R = model_axis / S
replica columns (replicas are extra data parallelism inside the model
axis); "data"/"pod" axes carry ordinary data parallelism.  The reference
runs one device per mesh position under ``shard_map`` and moves stage
boundaries by ring ``ppermute``.  The port runs every position in one
process on one device (:mod:`repro_torch.launch.mesh`): the stages of a
column hand their boundaries over in Python, one tick after they were
sent, and the R columns and data replicas run one after another, their
gradients summed.

Params: :func:`to_pipeline` groups the model's per-layer block list into
S stage slots of ``layers_per_stage`` entries; pad slots are empty dicts
(no leaves, no-ops).  Each layer is held once, so the optimizer's tree is
the model's and its global norm counts every stage once.  (The reference
keeps its ``(model_axis, lps, ...)`` layout, R copies of every stage, and
its ``grad_norm`` counts the blocks R times.)

Schedules, executed from :mod:`repro_torch.core.schedules`' tables:

* ``gpipe`` -- :func:`make_pp_loss`: the forward sweep keeps each (stage,
  microbatch) graph; the backward sweep, in ``gpipe_table``'s B order,
  calls ``torch.autograd.backward`` with the cotangent from the right.
* ``hybrid`` -- :func:`make_pp_hybrid_fb`, the paper's hybrid GPipe/1F1B
  (§3.5): the LAST stage runs forward, loss and backward of a microbatch
  in one tick (FB); earlier stages run their forward without a graph,
  stash their input and recompute the chunk in their B tick.

Loss normalisation is the reference's: each microbatch's mean CE / M,
summed over microbatches, then over columns / their count.  MoE archs are
excluded, as the reference asserts.  A frontend config (internvl2) takes
``batch["frontend"]`` (B, P, D): stage 0 puts each microbatch's rows ahead
of its tokens' embeddings, and the last stage's loss reads the positions
from P - 1 on, as ``lm_loss`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.convert import leaves, unflatten
from repro_torch.core import schedules as sched
from repro_torch.core.partition import PipelinePlan, plan_pipeline
from repro_torch.core import sharding as sh
from repro_torch.launch.mesh import dp_degree
from repro_torch.models import lm as LM
from repro_torch.models.api import build_model
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# param layout: the model's per-layer list  <->  S stage slots of lps layers
# ---------------------------------------------------------------------------

def to_pipeline(params: dict, plan: PipelinePlan) -> dict:
    """The blocks grouped into ``plan.n_stages`` lists of
    ``plan.layers_per_stage`` slots, pad slots ``{}``; the layer dicts and
    every other leaf are shared with ``params``, not copied."""
    lps = plan.layers_per_stage
    slots = list(params["blocks"]) + [{} for _ in range(plan.slots - len(params["blocks"]))]
    out = dict(params)
    out["blocks"] = [slots[s * lps:(s + 1) * lps] for s in range(plan.n_stages)]
    return out


def from_pipeline(params_pp: dict, plan: PipelinePlan, n_layers: int) -> dict:
    """Inverse of :func:`to_pipeline` (for checkpoints / evaluation)."""
    out = dict(params_pp)
    out["blocks"] = [bp for stage in params_pp["blocks"] for bp in stage][:n_layers]
    return out


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Geom:
    S: int
    R: int
    lps: int
    M: int
    b_mb: int          # sequences per microbatch (per column)
    t_tok: int         # token positions per sequence
    p_front: int       # frontend prefix length (vlm)
    msize: int         # model axis size

    @property
    def b_col(self) -> int:
        return self.b_mb * self.M


def geometry(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig,
             mesh) -> Tuple[PipelinePlan, _Geom]:
    """The reference's plan and geometry for ``mesh.shape``."""
    if cfg.n_experts:
        raise ValueError(f"{cfg.arch_id}: MoE archs train with gspmd_pp, not the pipeline")
    msize = mesh.shape["model"]
    plan = plan_pipeline(cfg.n_layers, msize, rcfg.microbatches, rcfg.schedule)
    dp = dp_degree(mesh)
    b_col = shape.global_batch // (dp * plan.replicas)
    if b_col < 1 or shape.global_batch % (dp * plan.replicas):
        raise ValueError(f"global batch {shape.global_batch} does not split into the {dp} x "
                         f"{plan.replicas} data x replica columns")
    m = min(plan.n_micro, b_col)
    while b_col % m:
        m -= 1
    p_front = cfg.frontend_seq if cfg.frontend else 0
    g = _Geom(S=plan.n_stages, R=plan.replicas, lps=plan.layers_per_stage, M=m,
              b_mb=b_col // m, t_tok=shape.seq_len - p_front, p_front=p_front, msize=msize)
    return dataclasses.replace(plan, n_micro=m), g


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineTrace:
    """What the last call of a schedule ran.

    ``log``: one ``(tick, stage, op, mb)`` per work item, op "F", "B" or
    (the hybrid's last stage) "FB", every column in turn; ``tick_bytes``:
    per column, the boundary bytes handed between stages in each tick (the
    reference's ppermute payload, counting only what a stage sends);
    ``stash_peak``: the most bytes the hybrid's stages held stashed at once."""

    log: List[Tuple[int, int, str, int]] = dataclasses.field(default_factory=list)
    tick_bytes: List[List[int]] = dataclasses.field(default_factory=list)
    stash_peak: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Column:
    """One column's run of a schedule table: the boundaries in flight
    between stages, the hybrid's stash or GPipe's kept graphs, and the sum
    of its microbatches' losses."""

    def __init__(self, cfg: ModelConfig, g: _Geom, rcfg: RunConfig, params: dict,
                 tokens: torch.Tensor, frontend: Optional[torch.Tensor], seed: torch.Tensor,
                 n_ticks: int, trace: PipelineTrace):
        self.cfg, self.g, self.rcfg, self.params = cfg, g, rcfg, params
        self.tokens, self.frontend, self.seed, self.trace = tokens, frontend, seed, trace
        self.cdt = LM.dtype_of(rcfg.compute_dtype)
        self.fwd: Dict[Tuple[int, int], Tuple[int, torch.Tensor]] = {}   # (to stage, mb)
        self.bwd: Dict[Tuple[int, int], Tuple[int, torch.Tensor]] = {}
        self.graphs: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
        self.stash: Dict[Tuple[int, int], torch.Tensor] = {}
        self.bytes = [0] * n_ticks
        self.loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        trace.tick_bytes.append(self.bytes)

    # -- pieces ------------------------------------------------------------
    def tok(self, mb: int) -> torch.Tensor:
        return self.tokens[mb * self.g.b_mb:(mb + 1) * self.g.b_mb].long()

    def embed(self, mb: int) -> torch.Tensor:
        """Microbatch ``mb``'s input rows: its frontend rows, where the batch
        has them, then its tokens' embeddings."""
        batch = {"tokens": self.tok(mb)}
        if self.frontend is not None:
            batch["frontend"] = self.frontend[mb * self.g.b_mb:(mb + 1) * self.g.b_mb]
        return LM.embed_inputs(self.params, batch, self.cdt)

    def chunk(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Stage ``s``'s layers (pad slots skipped) at their global indices."""
        blocks = [bp for bp in self.params["blocks"][s] if bp]
        return LM.layers_train(self.cfg, blocks, self.params.get("shared"), x, self.rcfg,
                               start=s * self.g.lps)[0]

    def head_loss(self, y: torch.Tensor, mb: int) -> torch.Tensor:
        return LM.head_loss(self.cfg, self.params, y, self.tok(mb), self.g.p_front) / self.g.M

    def send(self, box: dict, to: int, mb: int, t: int, x: torch.Tensor) -> None:
        box[(to, mb)] = (t, x.detach())
        self.bytes[t] += _nbytes(x)

    def recv(self, box: dict, s: int, mb: int, t: int) -> torch.Tensor:
        """The boundary sent to stage ``s`` for ``mb`` in the tick before ``t``
        (a ring transfer), as a leaf that takes a gradient."""
        sent = box.pop((s, mb), None)
        if sent is None or sent[0] != t - 1:
            raise RuntimeError(f"schedule fault: stage {s} at tick {t} needs microbatch {mb}'s "
                               f"boundary from tick {t - 1}, found {sent and sent[0]}")
        return sent[1].requires_grad_()

    # -- GPipe -------------------------------------------------------------
    def gpipe_f(self, t: int, s: int, mb: int) -> None:
        x = self.embed(mb) if s == 0 else self.recv(self.fwd, s, mb, t)
        y = self.chunk(s, x)
        if s == self.g.S - 1:
            y = self.head_loss(y, mb)
            self.loss += y.detach()
        else:
            self.send(self.fwd, s + 1, mb, t, y)
        self.graphs[(s, mb)] = (x, y)

    def gpipe_b(self, t: int, s: int, mb: int) -> None:
        x, y = self.graphs.pop((s, mb))
        last = s == self.g.S - 1
        torch.autograd.backward(y, self.seed if last else self.recv(self.bwd, s, mb, t))
        if s:
            self.send(self.bwd, s - 1, mb, t, x.grad)

    # -- hybrid GPipe/1F1B -------------------------------------------------
    def hybrid_f(self, t: int, s: int, mb: int) -> None:
        with torch.no_grad():
            if s == 0:
                x = self.embed(mb)
            else:
                x = self.stash[(s, mb)] = self.recv(self.fwd, s, mb, t).detach()
            self.send(self.fwd, s + 1, mb, t, self.chunk(s, x))

    def hybrid_b(self, t: int, s: int, mb: int) -> None:
        x = self.embed(mb) if s == 0 else self.stash.pop((s, mb)).requires_grad_()
        torch.autograd.backward(self.chunk(s, x), self.recv(self.bwd, s, mb, t))
        if s:
            self.send(self.bwd, s - 1, mb, t, x.grad)

    def hybrid_fb(self, t: int, s: int, mb: int) -> None:
        x = self.recv(self.fwd, s, mb, t)
        loss = self.head_loss(self.chunk(s, x), mb)
        torch.autograd.backward(loss, self.seed)
        self.loss += loss.detach()
        self.send(self.bwd, s - 1, mb, t, x.grad)

    def run(self, table: List[sched.Tick], hybrid: bool) -> None:
        S = self.g.S
        fwd, bwd = (self.hybrid_f, self.hybrid_b) if hybrid else (self.gpipe_f, self.gpipe_b)
        next_b = [0] * S                        # each stage's backwards run mb 0, 1, ...
        for t, tick in enumerate(table):
            for s, (op, mb) in enumerate(zip(tick.stage_ops, tick.mb)):
                if hybrid and s == S - 1 and op == sched.FUSED:
                    self.hybrid_fb(t, s, mb)
                    self.trace.log.append((t, s, sched.FUSED, mb))
                    continue
                if sched.FWD in op:
                    fwd(t, s, mb)
                    self.trace.log.append((t, s, sched.FWD, mb))
                if sched.BWD in op:
                    b = next_b[s]
                    if mb is not None and op == sched.BWD and mb != b:
                        raise RuntimeError(f"schedule fault: stage {s} at tick {t} runs the "
                                           f"backward of mb {mb}, expected {b}")
                    bwd(t, s, b)
                    next_b[s] += 1
                    self.trace.log.append((t, s, sched.BWD, b))
            held = sum(_nbytes(x) for x in self.stash.values())
            self.trace.stash_peak = max(self.trace.stash_peak, held)


class _Schedule:
    """``fn(params_pp, batch) -> (loss, grads)`` of one schedule: every
    column (data replica x replica column) run through the table in turn,
    gradients accumulated by autograd into the params' ``.grad`` and
    returned as a tree of the params' structure (the model's: each stage
    once).  ``trace`` describes the last call."""

    def __init__(self, cfg: ModelConfig, g: _Geom, rcfg: RunConfig, mesh, hybrid: bool):
        self.cfg, self.g, self.rcfg, self.hybrid = cfg, g, rcfg, hybrid
        self.dp = dp_degree(mesh)
        self.table = (sched.hybrid_table if hybrid else sched.gpipe_table)(g.S, g.M)
        self.trace = PipelineTrace()

    def __call__(self, params: dict, batch: Dict[str, torch.Tensor]):
        g = self.g
        tokens = batch["tokens"]
        frontend = batch.get("frontend")
        if tokens.shape[1] != g.t_tok or tokens.shape[0] != self.dp * g.R * g.b_col:
            raise ValueError(f"batch {tuple(tokens.shape)} is not {self.dp} x {g.R} columns "
                             f"of {g.b_col} sequences of {g.t_tok} tokens")
        rows = (tokens.shape[0], g.p_front) if g.p_front else None
        if (None if frontend is None else tuple(frontend.shape[:2])) != rows:
            raise ValueError(f"{self.cfg.arch_id} takes {g.p_front} frontend rows a sequence, "
                             f"got {None if frontend is None else tuple(frontend.shape)}")
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
            p.grad = None
        ncols = g.R * self.dp
        seed = torch.full((), 1.0 / ncols, dtype=torch.float32, device=tokens.device)
        self.trace = PipelineTrace()
        b_local = tokens.shape[0] // self.dp
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for d in range(self.dp):
            for r in range(g.R):
                row0 = d * b_local + r * g.b_col
                col = _Column(self.cfg, g, self.rcfg, params, tokens[row0:row0 + g.b_col],
                              None if frontend is None else frontend[row0:row0 + g.b_col],
                              seed, len(self.table), self.trace)
                col.run(self.table, self.hybrid)
                loss += col.loss
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
        for p in flat:
            p.grad = None
        return loss / ncols, unflatten(params, grads)


def make_pp_loss(cfg: ModelConfig, g: _Geom, rcfg: RunConfig, mesh) -> _Schedule:
    """GPipe: ``fn(params_pp, batch) -> (loss, grads)``."""
    return _Schedule(cfg, g, rcfg, mesh, hybrid=False)


def make_pp_hybrid_fb(cfg: ModelConfig, g: _Geom, rcfg: RunConfig, mesh) -> _Schedule:
    """The paper's hybrid fused F+B: ``fn(params_pp, batch) -> (loss, grads)``."""
    return _Schedule(cfg, g, rcfg, mesh, hybrid=True)


# ---------------------------------------------------------------------------
# public builder
# ---------------------------------------------------------------------------

def make_pp_train_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: RunConfig, mesh,
                       opt_cfg: Optional[adamw.AdamWConfig] = None, device="cuda") -> dict:
    """The pipelined train step on ``device`` (default ``cuda``):
    ``fn(params_pp, opt_state, batch) -> (params_pp, opt_state, metrics)``,
    AdamW over the pipeline tree (params and moments updated in place),
    with the reference's ``meta``, ``args`` (``meta`` stand-ins) and spec
    trees (:mod:`repro_torch.launch.steps`' keys); ``to_pipeline`` /
    ``from_pipeline`` convert params; ``schedule.trace`` is the last step's
    :class:`PipelineTrace`."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    plan, g = geometry(cfg, shape, rcfg, mesh)
    model = build_model(cfg, rcfg, device=device)
    fb = (make_pp_hybrid_fb if rcfg.schedule == "hybrid" else make_pp_loss)(cfg, g, rcfg, mesh)

    def train_step(params, opt_state, batch):
        loss, grads = fb(params, batch)
        params, opt_state, stats = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, dict(loss=loss, **stats)

    # the reference's shardings, in the stage-slot layout: a slot's stage
    # (its position on "model") is its list index
    pp_shape = to_pipeline(build_model(cfg, rcfg, device="meta").init(0), plan)
    batch_specs = model.input_specs(shape)
    _, p_ref, m_ref = sh.pp_shardmap_shardings(pp_shape, mesh)
    p_shard, m_shard = sh.to_port_layout(pp_shape, p_ref), sh.to_port_layout(pp_shape, m_ref)
    opt_shard = {"m": m_shard, "v": m_shard, "step": ()}
    b_shard = sh.map_with_path(lambda _, t: (sh.data_entry(mesh),) if t.dim() else (),
                               batch_specs)
    gpipe_ticks = g.M + g.S - 1
    hybrid_ticks = g.M + 2 * g.S - 2
    return dict(
        fn=train_step,
        args=(pp_shape, adamw.init(pp_shape), batch_specs),
        in_shardings=(p_shard, opt_shard, b_shard),
        out_shardings=(p_shard, opt_shard, {k: () for k in ("loss", "grad_norm", "lr")}),
        donate_argnums=(0, 1),
        meta={"strategy": "pp_shardmap", "schedule": rcfg.schedule,
              "S": g.S, "R": g.R, "M": g.M, "layers_per_stage": g.lps,
              "n_pad_layers": plan.n_pad,
              "ticks": plan.ticks(),
              "layers_multiplier": g.lps,
              "tick_multiplier": gpipe_ticks if rcfg.schedule == "gpipe" else hybrid_ticks,
              "wire_multiplier": 2 * gpipe_ticks if rcfg.schedule == "gpipe" else hybrid_ticks},
        model=model,
        plan=plan,
        geometry=g,
        schedule=fb,
        to_pipeline=functools.partial(to_pipeline, plan=plan),
        from_pipeline=functools.partial(from_pipeline, plan=plan, n_layers=cfg.n_layers),
    )
