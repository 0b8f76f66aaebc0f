"""Fault-tolerance supervisor: restart-from-checkpoint, stragglers, SIGTERM.

The port of ``repro/runtime/supervisor.py:28-111``: the same loop, over
the port's ``CheckpointManager``.

  * crash restart      — the supervisor catches any exception from the
    step function, restores the latest checkpoint (through ``build``),
    and resumes, at most ``max_restarts`` times.
  * preemption         — SIGTERM triggers a final synchronous checkpoint
    before the loop returns; ``run`` installs its handler and puts the one
    it found back when it returns (an installed handler that held the
    run's state would keep a finished run's model and moments in device
    memory).
  * straggler detection — per-step wall-time EWMA; a step exceeding
    ``straggler_factor`` x the EWMA is logged and counted (one process:
    the event is recorded, nothing is re-dispatched).
  * a checkpoint is saved only every ``ckpt_every`` steps, asynchronously;
    a restore puts each leaf on its template's device (the card the
    process has now).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

from ..checkpoint import CheckpointManager


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_n: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class StepStats:
    step: int
    wall_s: float
    is_straggler: bool
    loss: float


class TrainSupervisor:
    """Drives (state, batch) -> state' step functions with FT semantics.

    ``build``: () -> (state, step_fn, pipeline_pos) — called at start and
    after every crash restore; it must consult the checkpoint manager.
    """

    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self._ewma: float | None = None
        self.stats: list[StepStats] = []
        self.straggler_events: list[int] = []
        self._stop = False
        self._orig_handler = None

    # -- signals ----------------------------------------------------------------
    def install_sigterm(self):
        def handler(signum, frame):
            self._stop = True
        prev = signal.signal(signal.SIGTERM, handler)
        if self._orig_handler is None:        # not ours, from a restart
            self._orig_handler = prev

    # -- main loop ---------------------------------------------------------------
    def run(self, build: Callable, n_steps: int, log_every: int = 10):
        try:
            return self._run(build, n_steps, log_every)
        finally:
            if self._orig_handler is not None:
                signal.signal(signal.SIGTERM, self._orig_handler)
                self._orig_handler = None

    def _run(self, build: Callable, n_steps: int, log_every: int):
        restarts = 0
        while True:
            try:
                state, step_fn, start_step = build(self.ckpt)
                self.install_sigterm()
                for i in range(start_step, n_steps):
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, i)
                    wall = time.perf_counter() - t0
                    straggler = False
                    if self._ewma is not None and \
                            wall > self.cfg.straggler_factor * self._ewma:
                        straggler = True
                        self.straggler_events.append(i)
                    self._ewma = (wall if self._ewma is None else
                                  (1 - self.cfg.ewma_alpha) * self._ewma
                                  + self.cfg.ewma_alpha * wall)
                    loss = float(metrics.get("loss", float("nan")))
                    self.stats.append(StepStats(i, wall, straggler, loss))
                    if i % log_every == 0:
                        print(f"[train] step {i:5d} loss {loss:8.4f} "
                              f"wall {wall*1e3:7.1f} ms"
                              + ("  STRAGGLER" if straggler else ""))
                    if (i + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save_async(i + 1, state)
                    if self._stop:
                        print("[train] SIGTERM: final checkpoint at", i + 1)
                        self.ckpt.ckpt.save(i + 1, state)   # synchronous
                        return state
                self.ckpt.wait()
                return state
            except KeyboardInterrupt:
                raise
            except Exception as e:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                print(f"[train] CRASH ({type(e).__name__}: {e}); restart "
                      f"{restarts}/{self.cfg.max_restarts} from latest ckpt")
                continue
