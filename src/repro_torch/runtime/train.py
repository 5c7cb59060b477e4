"""Fault-tolerant training loop: checkpoint/restart, preemption recovery,
straggler monitoring, async checkpointing.

The port of ``repro.runtime.train``. The loop drives any
``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
(``runtime.steps.make_train_step``). State = (params, opt_state, pipeline
step counter), all captured in the checkpoint, so a restart after
preemption replays the same batches (and, on the CPU, the same bits).
Batches go to the parameters' device; a step is timed after its metrics
are read back to the host, which waits for the device (the reference's
``block_until_ready``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.optim.adamw import leaves, param_tree
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    n_hosts: int = 1  # simulated host count for straggler monitoring


class PreemptionError(RuntimeError):
    """Raised by test hooks to simulate a node failure mid-run."""


@dataclasses.dataclass
class TrainLoop:
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt, metrics)
    pipeline: Any  # data pipeline with .batch_at(step) and .state.step
    ckpt: CheckpointManager | None = None
    config: TrainLoopConfig = dataclasses.field(default_factory=TrainLoopConfig)
    # test hooks
    pre_step_hook: Callable[[int], None] | None = None
    host_time_fn: Callable[[int], list[float]] | None = None

    def restore_or_init(self, params, opt_state):
        """Resume from the latest checkpoint if one exists (in place)."""
        start = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            (params, opt_state), extra = self.ckpt.restore((params, opt_state))
            start = int(extra["data_step"])
            self.pipeline.state.step = start
        return params, opt_state, start

    def run(self, params, opt_state, start_step: int = 0):
        cfg = self.config
        device = leaves(param_tree(params))[0].device
        monitor = StragglerMonitor(cfg.n_hosts)
        metrics_log: list[dict] = []
        step = start_step
        while step < cfg.n_steps:
            if self.pre_step_hook is not None:
                self.pre_step_hook(step)
            t0 = time.monotonic()
            batch = {
                k: torch.from_numpy(v).to(device)
                for k, v in self.pipeline.batch_at(step).items()
            }
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            values = {k: float(v) for k, v in metrics.items()}  # waits for the device
            dt = time.monotonic() - t0
            host_times = (
                self.host_time_fn(step)
                if self.host_time_fn is not None
                else [dt] * cfg.n_hosts
            )
            flagged = monitor.record_step(host_times)
            metrics_log.append({"step": step, "time_s": dt, "stragglers": flagged, **values})
            step += 1
            self.pipeline.state.step = step
            if self.ckpt is not None and step % cfg.ckpt_every == 0:
                self.ckpt.save(
                    step,
                    (params, opt_state),
                    extra={"data_step": step},
                    blocking=not cfg.ckpt_async,
                )
        if self.ckpt is not None:
            self.ckpt.save(
                step, (params, opt_state), extra={"data_step": step}, blocking=True
            )
        return params, opt_state, metrics_log
