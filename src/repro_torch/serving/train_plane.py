"""Training plane: federated serve-while-train rounds over the fleet
(port of ``repro/serving/train_plane.py``).

The paper's headline result is *training* acceleration from idle phone
compute.  This module runs it on the serving fleet without a second
scheduler: a :class:`FedRoundCoordinator` wraps a
:class:`~repro_torch.serving.fleet.ServingFleet` and schedules device-scored
federated rounds into the workers' idle duty-cycle gaps.

Round lifecycle (all times simulated):

1. **Select** — among replica workers that are up, thermally at or below
   ``max_thermal_rank`` and serving-idle, pick the best
   ``participants`` by the same score shape routing uses (coolest, least
   backlog, fastest, name tiebreak).
2. **Local steps** — each participant runs ``local_steps`` real
   steps through the existing :class:`~repro_torch.runtime.trainer.Trainer`
   step machinery (fault-checked, thermally observed, timed on the
   fleet's SIM clock) over its own seeded synthetic shard
   (:class:`~repro_torch.data.synthetic.TokenPipeline`; deterministic in
   ``(seed, step, shard)``).  Like the pipeline/spec planes, compute is
   EAGER — results only become visible when the sim-time charges are
   paid.
3. **Charge** — the local compute is charged against the SAME per-tick
   credit budget decode spends (``acc_s``), only in ticks where the
   worker has no serving work and is thermally eligible — backlog or a
   SERIOUS thermal state preempts training instantly.  The encoded
   update (:func:`repro_torch.optim.fed.encode_update` — int8+error-feedback
   or bf16 wire frames) is then charged against the worker's link; a
   frame can stay in flight across ticks.
4. **Aggregate** — when every participant has delivered or failed (or
   the round deadline passes), the coordinator applies sample-weighted
   fed-avg (:func:`repro_torch.optim.fed.fed_avg`) over the DELIVERED frames
   in fixed sorted-name order — bit-deterministic under a seeded trace.
   A participant that died mid-round (the fleet's failure plane: crash, or a
   partition that outlived the round) is excluded from the weights; a
   partition that heals before the deadline resumes paying its charges
   and contributes normally.

The trained model is the coordinator's own ``params`` — deliberately
separate from the fleet's serving params, so serving streams stay
token-identical with the training plane on or off (asserted in tests);
only serving *timing* may shift, which the bench bounds via SLO
attainment A/B against a serve-only baseline.

Port notes.  Every participant starts its round from the global
``params``; the local step updates OUT OF PLACE (new tensors), so the
global params, and the next participant's start, stay as they were — an
in-place step would train the global params through every participant.
Update frames carry the delta in the reference's layout (the blocks
stacked into ``(L, ...)`` leaves, :func:`repro_torch.convert.stack_blocks`),
so the int8 codec's per-leaf scales and top-k are the reference's and a
frame decodes in either package.  With ``params=None`` the coordinator
draws its params from the port's own seeded init (``model.init(seed)``),
not from the reference's ``jax.random.key(seed)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.convert import leaves, stack_blocks, unflatten, unstack_blocks
from repro_torch.data.synthetic import DataConfig, TokenPipeline
from repro_torch.models.api import Model
from repro_torch.optim import fed
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving.fleet import ServingFleet, _Worker

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Knobs of the federated serve-while-train plane."""
    rounds: int = 4                 # target rounds (the plane stops after)
    local_steps: int = 2            # local steps per participant per round
    participants: int = 2           # selection target (fewer if ineligible)
    batch: int = 4                  # per-participant batch size
    seq_len: int = 32
    lr: float = 0.3                 # local SGD learning rate
    seed: int = 0                   # data + init seed
    mode: str = "int8_ef"           # update frames: "int8_ef" | "bf16"
    topk_frac: Optional[float] = 0.5   # int8_ef sparsity (EF keeps the rest)
    train_flops_mult: float = 3.0   # fwd+bwd+update cost vs one forward
    max_thermal_rank: int = 2       # preempt at SERIOUS (rank 2) or worse
    round_timeout_s: float = 60.0   # sim deadline before stragglers drop


@dataclasses.dataclass(frozen=True)
class FedRoundSnapshot:
    """One completed round, frozen (repro-lint R006: immutable outside
    this module)."""
    round_id: int
    t_begin: float
    t_end: float
    participants: Tuple[str, ...]
    delivered: Tuple[str, ...]
    excluded: Tuple[str, ...]
    samples: int                 # sequences behind the applied update
    wire_bytes: int              # fed frame bytes charged on links
    train_s: float               # sim compute seconds charged for training
    loss_first: float            # mean first-local-step loss (delivered)
    loss_last: float             # mean last-local-step loss (delivered)


def _local_sgd_step(model: Model, lr: float):
    """The local-SGD step — FedAvg's classic local optimiser: the loss and
    its gradient by autograd, then ``p - lr * g`` in fp32, cast back to
    each leaf's dtype.  The update is out of place: the step's input
    params are never written (the reference's arrays are immutable; see
    the module's port notes)."""
    def step_fn(params, opt, batch):
        b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
        # grad on even where the caller drives the fleet under no_grad
        with torch.enable_grad():
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            loss, _ = model.loss(unflatten(params, flat), b)
            grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            new = [(p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)
                   for p, g in zip(flat, grads)]
        return unflatten(params, new), opt, {"loss": loss.detach()}

    return step_fn


class _RoundState:
    """Mutable in-flight state of one participant's round leg."""

    def __init__(self, name: str, samples: int, frame: bytes,
                 comp_cold_s: float, link_s: float, new_error: Any,
                 losses: List[float]):
        self.name = name
        self.samples = samples
        self.frame = frame
        self.comp_rem = comp_cold_s   # cold compute seconds still unpaid
        self.link_rem = link_s        # wire seconds still unpaid
        self.frame_charged = False    # bytes counted when compute finishes
        self.new_error = new_error    # EF state, committed on delivery
        self.losses = losses
        self.delivered = False
        self.failed = False

    @property
    def resolved(self) -> bool:
        return self.delivered or self.failed


class FedRoundCoordinator:
    """Runs federated rounds inside a fleet's idle duty-cycle gaps.

    Drive it exactly like the fleet: ``coord.tick()`` advances the fleet
    one tick then pays/collects training charges; ``sim_t`` / ``idle`` /
    ``completed`` delegate, so :func:`repro_torch.serving.fleet.drive_sim`
    accepts a coordinator wherever it accepts a fleet."""

    def __init__(self, fleet: ServingFleet, model: Model, cfg: FedConfig,
                 params: Any = None):
        if not fleet.workers:
            raise ValueError("the training plane needs replica workers "
                             "(stage groups / spec pairs serve one model "
                             "across members and do not train)")
        self.fleet = fleet
        self.model = model
        self.cfg = cfg
        self.params = params if params is not None else model.init(cfg.seed)
        self._step_fn = _local_sgd_step(model, cfg.lr)
        # stable shard index per worker name: every participant trains on
        # its OWN slice of one shared bigram task (same transition table,
        # disjoint deterministic streams)
        names = sorted(w.name for w in fleet.workers)
        self._shard_of = {n: i for i, n in enumerate(names)}
        dcfg = DataConfig(vocab_size=model.cfg.vocab_size,
                          seq_len=cfg.seq_len,
                          global_batch=cfg.batch * len(names),
                          seed=cfg.seed)
        self._data = {n: TokenPipeline(dcfg, shard=self._shard_of[n],
                                       n_shards=len(names)) for n in names}
        self._trainer = {
            n: Trainer(TrainerConfig(worker_name=n), self._step_fn,
                       clock=fleet._sim_now)
            for n in names}
        self._error: Dict[str, Any] = {}      # persistent EF state per worker
        self._active: List[_RoundState] = []
        self._round_t0 = 0.0
        self._deadline = 0.0
        self.rounds: List[FedRoundSnapshot] = []
        self.rounds_done = 0
        self.deliveries = 0
        self.exclusions = 0
        self.wire_bytes_total = 0
        self.train_s_total = 0.0
        self.preempt_ticks = 0

    # -- drive_sim duck-typing -----------------------------------------
    @property
    def sim_t(self) -> float:
        return self.fleet.sim_t

    @property
    def completed(self):
        return self.fleet.completed

    def idle(self) -> bool:
        return self.fleet.idle() and not self._active

    def submit(self, *args, **kwargs):
        return self.fleet.submit(*args, **kwargs)

    def tick(self) -> None:
        self.fleet.tick()
        self._advance()

    def run_rounds(self, max_ticks: int = 100_000) -> List[FedRoundSnapshot]:
        """Tick until the configured rounds complete (serving traffic, if
        any, interleaves through the shared tick)."""
        for _ in range(max_ticks):
            if self.rounds_done >= self.cfg.rounds:
                break
            self.tick()
        return self.rounds

    # -- round machinery -----------------------------------------------
    def _worker(self, name: str) -> _Worker:
        w = self.fleet.worker(name)
        assert isinstance(w, _Worker)
        return w

    def _eligible(self, w: _Worker) -> bool:
        f = self.fleet
        return (not f._is_down(w.name)
                and f.thermal_rank(w.name) <= self.cfg.max_thermal_rank
                and w.engine.scheduler.depth == 0
                and w.engine.active() == 0)

    def _advance(self) -> None:
        if not self._active:
            if self.rounds_done < self.cfg.rounds:
                self._start_round()
            return
        self._pay()
        if (self.sim_t >= self._deadline
                and any(not p.resolved for p in self._active)):
            for p in self._active:
                if not p.resolved:
                    p.failed = True
        if all(p.resolved for p in self._active):
            self._finish_round()

    def _start_round(self) -> None:
        f = self.fleet
        cands = [w for w in f.workers if self._eligible(w)]
        if not cands:
            return

        def score(w: _Worker):
            backlog = w.engine.scheduler.depth + w.engine.active()
            return (f.thermal_rank(w.name), backlog, -w.rate, w.name)

        picked = sorted(cands, key=score)[:self.cfg.participants]
        cfg = self.cfg
        rid = self.rounds_done
        self._round_t0 = self.sim_t
        self._deadline = self.sim_t + cfg.round_timeout_s
        self._active = []
        for w in sorted(picked, key=lambda w: w.name):
            # EAGER local training (the charge queue paces delivery, like
            # the pipeline/spec planes): local_steps steps from the
            # current global params on this worker's seeded shard
            p_local, opt = self.params, {}
            losses: List[float] = []
            tr = self._trainer[w.name]
            for k in range(cfg.local_steps):
                step = rid * cfg.local_steps + k
                batch = self._data[w.name].batch(step)
                p_local, opt, rec = tr.train_step(p_local, opt, batch, step)
                losses.append(rec["loss"])
            # framed in the reference's layout (port notes)
            delta = stack_blocks(fed.tree_delta(p_local, self.params))
            del p_local
            frame, new_err = fed.encode_update(
                delta, mode=cfg.mode, error=self._error.get(w.name),
                topk_frac=cfg.topk_frac)
            samples = cfg.local_steps * cfg.batch
            comp_cold = (cfg.local_steps * cfg.train_flops_mult
                         * cfg.batch * cfg.seq_len / w.prefill_rate)
            link_s = len(frame) / w.spec.profile.link_bw
            self._active.append(_RoundState(
                w.name, samples, frame, comp_cold, link_s, new_err, losses))

    def _pay(self) -> None:
        f = self.fleet
        tick_s = f.tick_s
        for p in self._active:
            if p.resolved:
                continue
            if p.name in f._dead:
                # heartbeat-declared dead (crash, or partition past
                # detection that never returned): excluded from this round
                p.failed = True
                continue
            if f._is_down(p.name):
                continue             # down but undetected: no progress yet
            w = self._worker(p.name)
            if (f.thermal_rank(p.name) > self.cfg.max_thermal_rank
                    or w.engine.scheduler.depth > 0
                    or w.engine.active() > 0):
                self.preempt_ticks += 1   # serving or thermal preemption
                continue
            if p.comp_rem > _EPS:
                # training compute spends the SAME credit decode earns
                cost_now = p.comp_rem * w.slowdown
                pay = min(cost_now, max(w.acc_s, 0.0))
                if pay > 0.0:
                    w.acc_s -= pay
                    p.comp_rem -= pay / w.slowdown
                    self.train_s_total += pay
                    # training heats the device like any other busy time:
                    # next tick's thermal advance sees the added util
                    w.util = min(w.util + pay / tick_s, 1.0)
                if p.comp_rem > _EPS:
                    continue
            if not p.frame_charged:
                p.frame_charged = True
                self.wire_bytes_total += len(p.frame)
            # the update frame rides the link in parallel with compute
            # budgets elsewhere: up to one tick of wire time per tick,
            # in-flight across ticks when it outruns the budget
            pay_l = min(p.link_rem, tick_s)
            p.link_rem -= pay_l
            if p.link_rem <= _EPS:
                p.delivered = True

    def _finish_round(self) -> None:
        delivered = [p for p in self._active if p.delivered]
        excluded = [p for p in self._active if p.failed]
        updates = [fed.ClientUpdate(p.name, p.samples, p.frame)
                   for p in delivered]
        avg = fed.fed_avg(updates, self.model.device) if updates else None
        if avg is not None:
            self.params = fed.apply_update(self.params, unstack_blocks(avg))
        for p in delivered:
            if self.cfg.mode == "int8_ef":
                self._error[p.name] = p.new_error
        n = len(delivered)
        snap = FedRoundSnapshot(
            round_id=self.rounds_done,
            t_begin=self._round_t0,
            t_end=self.sim_t,
            participants=tuple(p.name for p in self._active),
            delivered=tuple(p.name for p in delivered),
            excluded=tuple(p.name for p in excluded),
            samples=sum(p.samples for p in delivered),
            wire_bytes=sum(len(p.frame) for p in delivered),
            train_s=self.train_s_total,
            loss_first=(sum(p.losses[0] for p in delivered) / n
                        if n else float("nan")),
            loss_last=(sum(p.losses[-1] for p in delivered) / n
                       if n else float("nan")))
        self.rounds.append(snap)
        self.rounds_done += 1
        self.deliveries += n
        self.exclusions += len(excluded)
        self._active = []


__all__ = ["FedConfig", "FedRoundSnapshot", "FedRoundCoordinator"]
