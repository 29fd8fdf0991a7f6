"""Fault-tolerance runtime: heartbeats, straggler detection, retry-with-
restore, and elastic re-mesh planning (the port's copy of the reference's
``repro.runtime.fault``, which is host-side numpy and imports no JAX).

On a real cluster these hooks bind to the coordination service; here the
host-side logic is fully implemented and driven by injected timings and
failures in tests. The policies (quantile straggler cutoff,
checkpoint-restore retry, data-axis shrink plan) are the deliverable, and
the trainer consumes them through this interface.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    slow_workers: List[int]
    p50: float
    p95: float
    cutoff: float


class HeartbeatMonitor:
    """Per-worker step-duration tracker with quantile-based straggler calls.

    A worker is a straggler if its rolling-median step time exceeds
    ``ratio`` x the fleet median over the window (typically 1.3–2x indicates
    memory ECC pressure or a failing host NIC).
    """

    def __init__(self, n_workers: int, window: int = 16, ratio: float = 1.5):
        self.n = n_workers
        self.window = window
        self.ratio = ratio
        self.times: List[deque] = [deque(maxlen=window) for _ in range(n_workers)]
        self.last_seen = np.zeros(n_workers)

    def record(self, worker: int, step_time: float, now: Optional[float] = None):
        self.times[worker].append(step_time)
        self.last_seen[worker] = time.monotonic() if now is None else now

    def dead_workers(self, timeout_s: float, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [i for i in range(self.n)
                if self.last_seen[i] and now - self.last_seen[i] > timeout_s]

    def stragglers(self) -> StragglerReport:
        meds = np.array([np.median(t) if t else np.nan for t in self.times])
        fleet = float(np.nanmedian(meds)) if np.any(~np.isnan(meds)) else 0.0
        cutoff = self.ratio * fleet
        slow = [i for i, m in enumerate(meds)
                if not np.isnan(m) and fleet > 0 and m > cutoff]
        p95 = float(np.nanpercentile(meds, 95)) if np.any(~np.isnan(meds)) else 0.0
        return StragglerReport(slow, fleet, p95, cutoff)


@dataclasses.dataclass
class RemeshPlan:
    """Elastic scaling: drop failed hosts by shrinking the data axis.

    The model axis is never resized (TP degree is baked into weight shards);
    capacity changes come out of data parallelism, and the global batch is
    either kept (more grad accumulation) or rescaled.
    """
    old_data: int
    new_data: int
    grad_accum_factor: int
    reshard_from_checkpoint: bool = True


def plan_remesh(data_size: int, failed_workers: int,
                keep_global_batch: bool = True) -> RemeshPlan:
    new = data_size - failed_workers
    # shrink to the largest power-of-two divisor layout we can keep
    while new > 1 and data_size % new != 0:
        new -= 1
    new = max(new, 1)
    accum = (data_size // new) if keep_global_batch else 1
    return RemeshPlan(data_size, new, accum)


class RetryPolicy:
    """Checkpoint-restore retry driver for the training loop."""

    def __init__(self, max_retries: int = 3, backoff_s: float = 1.0):
        self.max_retries = max_retries
        self.backoff_s = backoff_s

    def run(self, step_fn: Callable[[], object],
            restore_fn: Callable[[], None],
            on_failure: Optional[Callable[[int, Exception], None]] = None):
        for attempt in range(self.max_retries + 1):
            try:
                return step_fn()
            except Exception as e:  # noqa: BLE001 — any device/host fault
                if attempt == self.max_retries:
                    raise
                if on_failure:
                    on_failure(attempt, e)
                time.sleep(self.backoff_s * (2 ** attempt))
                restore_fn()
        raise RuntimeError("unreachable")
