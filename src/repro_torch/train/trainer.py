"""Fault-tolerant trainer: checkpoint/restart and straggler monitoring (the
port of ``repro.train.trainer``).

The loop is host-driven; the step is supplied by the model driver
(``make_train_step``): ``step_fn(params, opt_state, batch) -> (params,
opt_state, metrics)``, returning new trees. Restart contract: on any step
failure the ``RetryPolicy`` restores the latest checkpoint of the port's
``CheckpointManager`` and fast-forwards the deterministic data stream; the
training state is exactly (params, opt_state, step). The batch is fetched
inside the retried step, for the step it runs, so a restored run reads the
batches the uninterrupted run read (the reference fetches it once before
the retries and would re-run a restored step on the failed step's batch).
A step's time ends at ``torch.cuda.synchronize()`` when its loss is on the
card.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.fault import HeartbeatMonitor, RetryPolicy


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 2
    log_every: int = 10
    max_retries: int = 3


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable, stream,
                 params, opt_state, to_device: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.stream = stream
        self.params = params
        self.opt_state = opt_state
        self.to_device = to_device or (lambda b: b)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints)
        self.monitor = HeartbeatMonitor(n_workers=1)
        self.retry = RetryPolicy(max_retries=cfg.max_retries)
        self.step = 0
        self.history: list = []

    # -- restart contract ----------------------------------------------------
    def try_restore(self) -> bool:
        try:
            (self.params, self.opt_state), step, _ = self.ckpt.restore_latest(
                (self.params, self.opt_state))
            self.step = step
            return True
        except FileNotFoundError:
            return False

    def _restore_or_reset(self):
        if not self.try_restore():
            self.step = 0

    # -- main loop -------------------------------------------------------------
    def run(self, fail_injector: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        while self.step < self.cfg.total_steps:
            def one_step():
                if fail_injector is not None:
                    fail_injector(self.step)
                batch = self.to_device(self.stream.batch_at(self.step))
                # the loss sync keeps the measured step honest regardless
                # of obs_sync_spans: training always wants real step time
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = metrics["loss"]
                if isinstance(loss, torch.Tensor) and loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
                dt = time.perf_counter() - t0
                obs.observe_ms("train.step", dt)
                return params, opt_state, metrics, dt

            params, opt_state, metrics, dt = self.retry.run(
                one_step, self._restore_or_reset)
            self.params, self.opt_state = params, opt_state
            self.monitor.record(0, dt)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == 1:
                self.history.append(
                    {"step": self.step, "loss": float(metrics["loss"]),
                     "time_s": dt})
            if self.step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(self.step, (self.params, self.opt_state))
        self.ckpt.save(self.step, (self.params, self.opt_state))
        self.ckpt.wait()
        return {"history": self.history,
                "stragglers": self.monitor.stragglers()}
