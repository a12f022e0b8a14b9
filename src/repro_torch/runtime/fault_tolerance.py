"""Fault-tolerant training supervisor and straggler monitor (twin of
``repro.runtime.fault_tolerance``).

  * checkpoint/restart: a checkpoint every ``ckpt_every`` steps (async by
    default); an injected failure (a real fleet surfaces a NaN loss, a lost
    device or a heartbeat timeout the same way) restores the newest
    checkpoint and replays from its step;
  * elastic scaling: a ``reshard`` hook may hand the restored state to
    fewer devices; checkpoints hold host arrays, so resuming does not care;
  * stragglers: a per-shard step-time EMA flags shards slower than ``k``
    times the median.

The state is a tree of tensors. `CheckpointManager.save` copies its leaves
to the host on the caller's thread before an async write, so a step that
updates the weights in place (the supernet step does) cannot reach a
snapshot already taken.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 20
    max_restarts: int = 8
    async_ckpt: bool = True


class TrainSupervisor:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` with checkpoints,
    recovery and deterministic replay: ``make_batch(step)`` must depend on
    ``step`` alone, so that a replay after a restore recomputes the same
    steps."""

    def __init__(self, step_fn: Callable, make_batch: Callable[[int], Any],
                 ckpt: CheckpointManager, cfg: SupervisorConfig = SupervisorConfig()):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.ckpt = ckpt
        self.cfg = cfg
        self.restarts = 0
        self.failures: List[str] = []

    def run(self, state: Any, start_step: int, n_steps: int,
            failure_hook: Optional[Callable[[int], None]] = None,
            reshard: Optional[Callable[[Any], Any]] = None) -> Any:
        step = start_step
        end = start_step + n_steps
        while step < end:
            try:
                if failure_hook is not None:
                    failure_hook(step)      # may raise InjectedFailure
                state, _ = self.step_fn(state, self.make_batch(step))
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state, meta={"step": step},
                                   blocking=not self.cfg.async_ckpt)
            except InjectedFailure as e:
                self.restarts += 1
                self.failures.append(f"step {step}: {e}")
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                self.ckpt.wait()
                if self.ckpt.latest_step() is None:     # crashed before the first checkpoint
                    raise
                state, meta = self.ckpt.restore(state)
                step = int(meta["step"])
                if reshard is not None:                 # elastic resize after a host loss
                    state = reshard(state)
        self.ckpt.wait()
        self.ckpt.save(step, state, meta={"step": step}, blocking=True)
        return state


class StragglerMonitor:
    """Per-shard step-time EMA; flags shards slower than ``k`` x the median."""

    def __init__(self, n_shards: int, k: float = 1.5, decay: float = 0.8):
        self.t = np.zeros(n_shards)
        self.k, self.decay = k, decay
        self._init = np.zeros(n_shards, dtype=bool)

    def record(self, shard: int, dt: float) -> None:
        if not self._init[shard]:
            self.t[shard], self._init[shard] = dt, True
        else:
            self.t[shard] = self.decay * self.t[shard] + (1 - self.decay) * dt

    def stragglers(self) -> np.ndarray:
        if not self._init.any():
            return np.zeros(0, dtype=int)
        med = np.median(self.t[self._init])
        return np.flatnonzero(self._init & (self.t > self.k * med))
