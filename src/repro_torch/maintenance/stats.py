"""Per-partition maintenance statistics, tracked incrementally at write time.

The adaptive maintenance loop decides from four signals, each cheap enough
to maintain on the write path itself:

- **heat** — probe hits per partition. Already tracked by
  ``partitioner.WorkloadStats`` (the executor's seed stage records every
  probe list); the summary reads it, this module does not duplicate it.
- **delta pressure** — the delta store's append watermark vs. capacity
  (O(1) from the store itself): every query scans the whole delta, so its
  fill is pure per-query cost.
- **tombstone ratio** — ``dead``: stable rows per partition hidden by a
  tombstone or superseded bit. Incremented by the facade on ``delete`` /
  update (one id→partition lookup against a lazily built slab map),
  decremented by the executor when a drain overwrites or a merge purges the
  dead row.
- **centroid drift** — mean assigned-vector distance of *newly written*
  rows vs. the build-time ``baseline`` per partition. ``record_writes``
  accumulates (Σdist, n) at insert time from ``assign_with_distance``;
  ``drift_ratio`` is the relative growth. A recluster/split resets the
  accumulators and re-baselines the partition.

The counters are host numpy, as in the reference (``repro.maintenance
.stats``): they only parameterise ``cost_model.plan_maintenance``. The
id → partition map lives on the index's device (built there by one
scatter; the answer is the reference's host map's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import delta as delta_mod
from repro_torch.core.cost_model import MaintenanceSummary
from repro_torch.core.partitioner import assign_with_distance, parked_mask

# drift is only trusted once this many writes have accumulated in a
# partition (a handful of rows says nothing about the centroid)
_MIN_DRIFT_WRITES = 8


def member_distance_stats(vectors: torch.Tensor, centroids: torch.Tensor):
    """(mean_dist (K,), counts (K,)) of ``vectors`` under their Eq. 1
    assignment — the build-time baseline the drift signal compares against."""
    a, d2 = assign_with_distance(vectors, centroids)
    a = a.cpu().numpy()
    dist = np.sqrt(d2.cpu().numpy().astype(np.float64))
    k = centroids.shape[0]
    counts = np.bincount(a, minlength=k).astype(np.int64)
    sums = np.bincount(a, weights=dist, minlength=k)
    return sums / np.maximum(counts, 1), counts


class PartitionStats:
    """Write-time accumulators for one modality's stable store."""

    def __init__(self, n_partitions: int, max_ids: int):
        self.n_partitions = n_partitions
        self.max_ids = max_ids
        self.baseline = np.zeros(n_partitions)          # mean dist at build
        self.drift_sum = np.zeros(n_partitions)
        self.drift_cnt = np.zeros(n_partitions, np.int64)
        self.dead = np.zeros(n_partitions, np.int64)    # tombstoned/superseded
        self.parked = np.zeros(n_partitions, bool)
        self._part_of: Optional[torch.Tensor] = None    # lazy id -> partition

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def from_build(cls, vectors, ids, ivf, max_ids: int) -> "PartitionStats":
        """Fresh stats for a just-built stable store: baseline distances
        from the build's own assignment, everything else zero."""
        st = cls(ivf.n_partitions, max_ids)
        if vectors.shape[0]:
            st.baseline, _ = member_distance_stats(vectors, ivf.centroids)
        st.parked = parked_mask(ivf.centroids)
        return st

    def rebaseline(self, vectors, ivf):
        """Re-anchor after a full rebuild (compaction with refreshed layout):
        current members become the new baseline, accumulators clear."""
        if vectors.shape[0]:
            self.baseline, _ = member_distance_stats(vectors, ivf.centroids)
        self.drift_sum[:] = 0.0
        self.drift_cnt[:] = 0
        self.parked = parked_mask(ivf.centroids)
        self.invalidate_slab()

    def reset_partition(self, p: int, baseline: float, parked: bool = False):
        """One partition re-centered (recluster) or re-filled (split/merge):
        new baseline, cleared accumulators."""
        self.baseline[p] = baseline
        self.drift_sum[p] = 0.0
        self.drift_cnt[p] = 0
        self.dead[p] = 0
        self.parked[p] = parked

    # ------------------------------------------------------------ write path
    def record_writes(self, assignment: np.ndarray, dist2: np.ndarray):
        """Accumulates the drift signal for an insert batch (assignment and
        squared distances from ``partitioner.assign_with_distance``)."""
        a = np.asarray(assignment).reshape(-1)
        d = np.sqrt(np.asarray(dist2, np.float64).reshape(-1))
        np.add.at(self.drift_sum, a, d)
        np.add.at(self.drift_cnt, a, 1)

    def record_dead(self, ids: np.ndarray, ivf):
        """A delete or update just hid stable rows: bump the owning
        partitions' dead counters (ids without a stable row are delta-only
        and cost nothing at probe time)."""
        part = self.partition_of(ids, ivf)
        part = part[part >= 0]
        if part.size:
            np.add.at(self.dead, part, 1)

    def partition_of(self, ids: np.ndarray, ivf) -> np.ndarray:
        """id -> owning partition (-1 when the id has no stable slot), via a
        lazily built slab map on the slab's device. ``invalidate_slab``
        drops the map whenever slots move."""
        if self._part_of is None:
            slab_ids = ivf.ids.reshape(-1)
            dev = slab_ids.device
            part = (torch.arange(slab_ids.shape[0], device=dev)
                    // ivf.capacity).to(torch.int32)
            m = torch.full((self.max_ids,), -1, dtype=torch.int32, device=dev)
            ok = slab_ids >= 0
            m[slab_ids[ok].clamp(0, self.max_ids - 1).long()] = part[ok]
            self._part_of = m
        ids = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                              device=self._part_of.device)
        return self._part_of[ids.clamp(0, self.max_ids - 1)].cpu().numpy()

    def invalidate_slab(self):
        self._part_of = None

    # -------------------------------------------------------------- planning
    def drift_ratio(self) -> np.ndarray:
        """(K,) relative growth of the mean assigned distance vs. baseline
        (0 where too few writes accumulated to trust the estimate)."""
        cur = self.drift_sum / np.maximum(self.drift_cnt, 1)
        ok = (self.drift_cnt >= _MIN_DRIFT_WRITES) & (self.baseline > 1e-9)
        return np.where(ok, cur / np.maximum(self.baseline, 1e-9) - 1.0, 0.0)

    def summarize(self, m, heat: Optional[np.ndarray]) -> MaintenanceSummary:
        """Snapshot for ``cost_model.plan_maintenance``. O(K) from the
        incremental counters plus the delta's live-slot scan (O(delta cap))."""
        counts = m.ivf.counts.cpu().numpy().astype(np.int64)
        dead = np.minimum(self.dead, counts)
        return MaintenanceSummary(
            live=counts - dead,
            free=np.int64(m.ivf.capacity) - counts,
            heat=(np.zeros(self.n_partitions, np.int64) if heat is None
                  else np.asarray(heat, np.int64)),
            dead=dead,
            drift=self.drift_ratio(),
            parked=self.parked.copy(),
            delta_live=int(delta_mod.live_slots(m.delta).size),
            delta_used=int(m.delta.count),
            delta_capacity=int(m.delta.vectors.shape[0]),
            cap=int(m.ivf.capacity),
        )
