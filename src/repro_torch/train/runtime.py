"""Fault-tolerant training runtime.

The port of ``repro/train/runtime.py``:

* **checkpoint/restart** — ``TrainRuntime.run`` checkpoints every
  ``ckpt_every`` steps (and the last) through the atomic
  :class:`~.checkpoint.CheckpointManager` and, on any exception from the
  step function, restores the latest checkpoint and replays (the data
  pipeline is stateless-resumable, so the stream is bit-identical).
  ``max_restarts`` bounds flapping.
* **restore onto a device** — restore puts the leaves on ``device``
  (default ``cuda:0``), where ``repro`` re-shards onto the current mesh's
  shardings; on a host mesh (``mesh``, a rank's view, and ``specs``, the
  spec tree of ``(params, state)``'s blocks) each rank saves its part of
  the gathered checkpoint and restores its blocks.
* **straggler mitigation** — steps slower than ``straggler_factor`` x the
  trailing median are counted and surfaced in the metrics.
* **failure injection** — ``fail_at_step`` raises once inside the loop to
  exercise the restart path.

The step function updates parameters and state in place and returns
them; a restart replaces both with the checkpoint's.  ``repro``'s step is
functional, so it can also replay from the initial state when nothing has
been saved; here a step that failed after it began may have written part
of its update, so a failure with no checkpoint restarts from the initial
state only when the step function had not been entered, and raises
otherwise.  A batch's tokens go to ``device`` as an int64 tensor unless
``batch_to_device`` is given.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from ..core.devices import resolve_device
from .checkpoint import CheckpointManager

__all__ = ["TrainRuntime", "RuntimeConfig"]


@dataclass
class RuntimeConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    max_restarts: int = 3
    straggler_factor: float = 2.0
    fail_at_step: int | None = None     # test hook: raise once at this step


@dataclass
class TrainRuntime:
    cfg: RuntimeConfig
    train_step: object                   # (params, state, batch) -> ...
    data_source: object                  # .batch(step) -> np array
    device: object = None                # where restored leaves go
    mesh: object = None                  # a rank's view of a host mesh
    specs: object = None                 # spec tree of (params, state)

    _failed_once: bool = field(default=False, init=False)

    def _to_device(self, batch: dict) -> dict:
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(v).to(device=dev, dtype=torch.int64)
                for k, v in batch.items()}

    def run(self, params, state, n_steps: int, batch_to_device=None):
        mgr = CheckpointManager(self.cfg.ckpt_dir,
                                keep_last=self.cfg.keep_last)
        to_device = batch_to_device or self._to_device
        restarts = 0
        step = 0
        # resume if a checkpoint exists
        if mgr.latest_step() is not None:
            (params, state), step = mgr.restore(
                (params, state), device=self.device, mesh=self.mesh,
                specs=self.specs)
            step += 1
        metrics_hist = []
        step_times: list[float] = []
        stragglers = 0
        entered = False     # whether a step may have written params/state
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if (self.cfg.fail_at_step == step and not self._failed_once):
                    self._failed_once = True
                    raise RuntimeError(f"injected node failure @step {step}")
                batch = to_device({"tokens": self.data_source.batch(step)})
                entered = True
                params, state, metrics = self.train_step(params, state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                if len(step_times) >= 5:
                    med = statistics.median(step_times[-20:])
                    if dt > self.cfg.straggler_factor * med:
                        stragglers += 1
                step_times.append(dt)
                metrics.update(step=step, step_time=dt,
                               stragglers=stragglers, restarts=restarts)
                metrics_hist.append(metrics)
                if step % self.cfg.ckpt_every == 0 or step == n_steps - 1:
                    mgr.save(step, (params, state), mesh=self.mesh,
                             specs=self.specs)
                step += 1
            except (KeyboardInterrupt,):
                raise
            except Exception as exc:  # lint: disable=typed-errors -- restart path: any step failure restores the last checkpoint
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from exc
                if mgr.latest_step() is None:
                    if entered:
                        raise RuntimeError(
                            f"step {step} failed after it began to update "
                            "the parameters in place, and no checkpoint "
                            "exists to replay from") from exc
                    # nothing saved and nothing written: replay from the
                    # initial state
                    step = 0
                    continue
                (params, state), last = mgr.restore(
                    (params, state), device=self.device, mesh=self.mesh,
                    specs=self.specs)
                step = last + 1
        return params, state, metrics_hist
