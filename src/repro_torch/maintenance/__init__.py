"""Adaptive index maintenance — the paper's "adaptive, low-overhead index
updates" pillar (the port of ``repro.maintenance``).

Three layers, host orchestration over device slot gathers and scatters:

- ``stats.PartitionStats`` — per-partition statistics tracked incrementally
  at write time (heat via the workload tracker, delta pressure, tombstone
  ratio, centroid drift vs. the build-time baseline);
- ``cost_model.plan_maintenance`` (in ``repro_torch.core.cost_model``) —
  the cost-driven policy choosing among split-hot / merge-cold / recluster
  / incremental-compact / no-op, greedily by estimated query-time benefit
  per row of bounded work;
- ``executor`` — applies each action as slot surgery (byte-identical row
  moves, fixed-size delta drains) instead of a stop-the-world rebuild.

The facade entry point is ``HMGIIndex.maintain(budget=...)``; ``insert`` /
``delete`` auto-trigger it (``cfg.maint_auto``), and the serving layer paces
it between decode steps (``serving.scheduler.MaintenanceDriver``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.cost_model import (MaintenanceAction,
                                         MaintenanceSummary,
                                         plan_maintenance)
from repro_torch.maintenance.stats import PartitionStats

__all__ = ["MaintenanceAction", "MaintenanceSummary", "MaintenanceReport",
           "PartitionStats", "plan_maintenance"]


@dataclasses.dataclass
class MaintenanceReport:
    """What one ``HMGIIndex.maintain`` call planned and applied.

    ``actions`` pairs each planned ``MaintenanceAction`` with the executor's
    result dict (``note`` plus per-action counters). ``describe()`` renders
    the applied sequence in one line — also what ``HMGIIndex`` surfaces in
    its metrics under ``"maintenance"``."""
    modality: str
    actions: List[Tuple[MaintenanceAction, Dict]] = \
        dataclasses.field(default_factory=list)

    @property
    def is_noop(self) -> bool:
        return not self.actions

    def describe(self) -> str:
        if not self.actions:
            return f"{self.modality}: noop"
        steps = " -> ".join(f"{a.kind}[{r.get('note', '')}]"
                            for a, r in self.actions)
        return f"{self.modality}: {steps}"
