"""Fault-tolerant training loop (port of ``repro/runtime/trainer.py``).

Wires together: a step function -> data iterator -> async wire-codec
checkpoints -> thermal monitor -> failure recovery (restore the latest
checkpoint and resume).  The step function, the initial state and the
data are injected, as in the reference; the reference's resharding on
restore (``shardings``) has nothing to place on the port's one device: a
restored leaf lands on the device of the state ``init_state`` builds.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore
from repro_torch.runtime.faults import FaultPlan, WorkerFailure
from repro_torch.runtime.monitor import ThermalMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "build/repro_ckpt"       # relative to the working directory
    log_every: int = 10
    max_restarts: int = 3
    worker_name: str = "worker0"


class Trainer:
    def __init__(self, tcfg: TrainerConfig, step_fn: Callable,
                 init_state: Optional[Callable[[], tuple]] = None,
                 data_iter_fn: Optional[Callable[[int], Iterator]] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 on_metrics: Optional[Callable[[int, dict], None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        """init_state() -> (params, opt_state); data_iter_fn(start_step)
        yields batches; step_fn(params, opt, batch) -> (params, opt, metrics).

        ``clock`` is the time source step latencies are measured on (the
        wall clock by default, or any injected clock).  ``init_state`` /
        ``data_iter_fn`` are only required by :meth:`run`; a caller that
        owns its state and batches may call :meth:`train_step` directly."""
        self.cfg = tcfg
        self.step_fn = step_fn
        self.init_state = init_state
        self.data_iter_fn = data_iter_fn
        self.faults = fault_plan or FaultPlan()
        self.monitor = ThermalMonitor()
        self.ckpt = AsyncCheckpointer(Path(tcfg.ckpt_dir))
        self.on_metrics = on_metrics
        self.clock = clock
        self.history: List[dict] = []
        self.restarts = 0
        self._recovered: set = set()     # failure steps already survived

    # ------------------------------------------------------------------
    def train_step(self, params, opt, batch, step: int):
        """One fault-checked, clock-timed, thermally-observed step.
        Returns ``(params, opt, record)``."""
        if step not in self._recovered:
            self.faults.check(step)                   # injected failures
        t0 = self.clock()
        params, opt, metrics = self.step_fn(params, opt, batch)
        loss = float(metrics["loss"])  # the step's one host sync, timed as part of dt
        dt = self.clock() - t0
        dt *= self.faults.slowdown(self.cfg.worker_name, step)
        ws = self.monitor.observe(self.cfg.worker_name, dt)
        rec = dict(step=step, loss=loss, step_s=dt,
                   thermal=ws.state.value, slowdown=round(ws.slowdown, 4))
        self.history.append(rec)
        if self.on_metrics:
            self.on_metrics(step, rec)
        return params, opt, rec

    # ------------------------------------------------------------------
    def _start_state(self):
        if self.init_state is None or self.data_iter_fn is None:
            raise ValueError("Trainer.run() needs init_state and data_iter_fn; "
                             "step-driven callers use train_step() instead")
        params, opt = self.init_state()
        start = 0
        last = latest_step(Path(self.cfg.ckpt_dir))
        if last is not None:
            tree, extra = restore(Path(self.cfg.ckpt_dir), last,
                                  like={"params": params, "opt": opt})
            params, opt = tree["params"], tree["opt"]
            start = int(extra.get("next_step", last))
            print(f"[trainer] restored step {last}, resuming at {start}")
        return params, opt, start

    def run(self) -> Dict[str, Any]:
        while True:
            try:
                return self._run_once()
            except WorkerFailure as e:
                # the plan is non-mutating; the trainer records which
                # failure steps it survived so that a restart resuming at
                # or before e.step does not trip the same fault forever
                self._recovered.add(e.step)
                self.restarts += 1
                print(f"[trainer] {e} — restart {self.restarts}/{self.cfg.max_restarts}")
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()

    def _run_once(self) -> Dict[str, Any]:
        params, opt, start = self._start_state()
        data = self.data_iter_fn(start)
        losses = []
        for step in range(start, self.cfg.total_steps):
            batch = next(data)
            params, opt, rec = self.train_step(params, opt, batch, step)
            loss = rec["loss"]
            losses.append(loss)
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step:5d} loss {loss:.4f} "
                      f"({rec['step_s']*1e3:.0f} ms, {rec['thermal']})")
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1, {"params": params, "opt": opt},
                                     extra={"next_step": step + 1})
        self.ckpt.wait()
        return {"params": params, "opt": opt, "losses": losses, "history": self.history}
