"""Fault-tolerance supervisor: checkpoint/restart, failure injection,
straggler mitigation — the control loop a 1000-node job runs under.

The port of ``src/repro/checkpointing/supervisor.py``. A restart joins a
pending asynchronous save first, then restores the latest checkpoint into
the live state (``checkpoint.restore`` copies in place, so the train step
that closes over the model's tensors goes on with the restored values).

On real clusters the failure signal is a missed heartbeat from the
process group / the platform scheduler; here failures are injectable
callables so the whole recovery path is unit-testable on one CPU host:

  * step raises Preemption/HardwareFailure  -> restore from latest
    checkpoint (params+opt+data iterator), rebuild the step, continue;
  * repeated failure at the same step       -> abort after max_retries
    (poison batch guard);
  * straggler mitigation: per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged and counted — on a real
    cluster this triggers a hot-spare swap; here it feeds the metrics so
    tests can assert detection. A step's time includes reading its
    metrics to the host, so on the card it is the step's wall time, not
    the time to queue it;
  * elastic re-mesh: on restore the caller may hand a new shard_fn
    (smaller/larger data axis) — supported by checkpoint.restore.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from . import checkpoint as ckpt


class Preemption(RuntimeError):
    """Node lost / preempted; recoverable by restart."""


class HardwareFailure(RuntimeError):
    """Chip-level failure; recoverable by restart on spares."""


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    async_save: bool = True


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, train_step: Callable,
                 state: Any, data,
                 fail_hook: Callable[[int], None] | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.state = state
        self.data = data
        self.fail_hook = fail_hook or (lambda step: None)
        self.metrics_log: list[dict] = []
        self.restarts = 0
        self.stragglers = 0
        self._ewma = None
        self._save_thread = None

    # ------------------------------------------------------------ control
    def _maybe_save(self, step: int) -> None:
        if step % self.cfg.ckpt_every == 0:
            if self._save_thread is not None:
                self._save_thread.join()
            self._save_thread = ckpt.save(
                self.cfg.ckpt_dir, step, self.state,
                data_state=self.data.snapshot(),
                asynchronous=self.cfg.async_save)

    def _restore(self) -> int:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        state, data_state, step = ckpt.restore(self.cfg.ckpt_dir, self.state)
        self.state = state
        if data_state is not None:
            self.data.restore(data_state)
        self.restarts += 1
        return step

    def run(self, n_steps: int, start_step: int = 0) -> dict:
        step = start_step
        retries_at = {}
        # initial checkpoint so step-0 failures are recoverable
        ckpt.save(self.cfg.ckpt_dir, step, self.state,
                  data_state=self.data.snapshot())
        while step < n_steps:
            batch = self.data.next()
            t0 = time.perf_counter()
            try:
                self.fail_hook(step)           # injection point
                self.state, metrics = self.train_step(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            except (Preemption, HardwareFailure) as e:
                retries_at[step] = retries_at.get(step, 0) + 1
                if retries_at[step] > self.cfg.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {retries_at[step]} times") from e
                step = self._restore()
                continue
            dt = time.perf_counter() - t0
            if self._ewma is None:
                self._ewma = dt
            else:
                if dt > self.cfg.straggler_factor * self._ewma:
                    self.stragglers += 1
                self._ewma = 0.9 * self._ewma + 0.1 * dt
            self.metrics_log.append({"step": step, "dt": dt, **metrics})
            step += 1
            self._maybe_save(step)
        if self._save_thread is not None:
            self._save_thread.join()
        return {"steps": step, "restarts": self.restarts,
                "stragglers": self.stragglers,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None}
