"""Modality-aware K-means partitioning (paper Eq. 1) + workload statistics.

``Cluster Assignment = argmin_c ||e - mu_c||^2`` — fitted per modality. The
assignment is one matmul: argmin_c ||e-mu||² = argmax_c (e·mu - ||mu||²/2),
which is how both ``fit`` and ``assign`` are written here.

Parked partitions: a merged-away partition keeps its slot in the
fixed-shape (K, ...) layout but its centroid is replaced with the
``parked_centroid`` sentinel, whose norm makes ``e·mu - ||mu||²/2``
astronomically negative, so neither ``assign`` nor ``assign_topk`` ever
routes a vector or a probe there ahead of a live partition.

Seeding: the reference draws its initial samples with ``jax.random.choice``,
which torch cannot reproduce; ``fit`` draws them from a ``torch.Generator``
instead, or takes them as ``init_idx`` (the parity tests inject the
reference's).
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.reduce import row_dot
from repro_torch.common.topk import top_k
from repro_torch.kernels.segment_reduce.ops import (segment_sum,
                                                    segment_sum_csr)
from repro_torch.kernels.segment_reduce.ref import csr_from_ids


class KMeansState(NamedTuple):
    centroids: torch.Tensor     # (K, d)
    counts: torch.Tensor        # (K,) assignment counts from the last fit
    inertia: torch.Tensor       # scalar: mean squared distance


def _scores(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)      # (K,)
    return x @ centroids.T - half_sq[None, :]                     # (N, K)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Eq. 1: nearest-centroid ids for x (N, d). One matmul + argmax."""
    return torch.argmax(_scores(x, centroids), dim=-1).to(torch.int32)


def assign_topk(x: torch.Tensor, centroids: torch.Tensor, k: int):
    """Top-k nearest centroids (used for n_probe partition selection). The
    query rows are scored in ``row_dot``'s order (one (Q, K, d) product):
    a query's probes and their order do not depend on its batch."""
    half_sq = 0.5 * torch.sum(centroids * centroids, dim=-1)
    scores = row_dot(x[:, None, :], centroids[None, :, :]) - half_sq[None, :]
    vals, idx = top_k(scores, k)
    return idx.to(torch.int32), vals


def assign_with_distance(x: torch.Tensor, centroids: torch.Tensor):
    """Eq. 1 assignment plus the squared distance to the winning centroid.
    Returns ``(assignment (N,) int32, dist2 (N,) fp32)``."""
    a = assign(x, centroids)
    d = x - centroids[a.long()]
    return a, torch.sum(d * d, dim=-1)


# ---------------------------------------------------------------------------
# parked partitions (merge-cold leaves the slot, retires the centroid)
# ---------------------------------------------------------------------------

# any centroid with norm beyond this is a parked sentinel: its assignment
# score e·mu - ||mu||²/2 ≈ -PARKED_NORM²/2 can never beat a live centroid's
PARKED_NORM = 32768.0


def parked_centroid(dim: int) -> np.ndarray:
    """The sentinel centroid of a merged-away partition (see module doc)."""
    c = np.zeros((dim,), np.float32)
    c[0] = PARKED_NORM
    return c


def parked_mask(centroids) -> np.ndarray:
    """(K,) bool — which partitions are parked (centroid is the sentinel)."""
    c = (centroids.detach().cpu().numpy() if isinstance(centroids, torch.Tensor)
         else np.asarray(centroids))
    return np.sum(c * c, axis=-1) >= (0.5 * PARKED_NORM) ** 2


def live_partitions(centroids) -> int:
    """Number of partitions that can win an assignment / deserve a probe."""
    return int(np.sum(~parked_mask(centroids)))


# rows per run of the card's two-level cluster sums (``run_sums``)
RUN_ROWS = 256


def run_sums(x: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) sums of ``x``'s rows by cluster ``a``, in two fixed-order
    CSR segment sums: each cluster's rows, in stable order, are cut into
    runs of ``RUN_ROWS``; the runs are summed, then each cluster's runs in
    order. The same bits in every process, and ~N/RUN_ROWS segments at
    work where a segment per cluster leaves k warps to read N/k rows each
    (43 ms an iteration at 1,048,576 × 384, k 64, on an H100)."""
    rowptr, perm = csr_from_ids(a, k)
    rowptr = rowptr.long()
    n_runs = (rowptr[1:] - rowptr[:-1] + RUN_ROWS - 1) // RUN_ROWS
    run_ptr = torch.zeros((k + 1,), dtype=torch.int64, device=x.device)
    run_ptr[1:] = torch.cumsum(n_runs, 0)
    total = int(run_ptr[-1])
    cluster = torch.repeat_interleave(
        torch.arange(k, device=x.device), n_runs, output_size=total)
    step = torch.arange(total, device=x.device) - run_ptr[cluster]
    starts = torch.cat([rowptr[cluster] + step * RUN_ROWS, rowptr[-1:]])
    partials = segment_sum_csr(x, starts.to(torch.int32), perm)
    return segment_sum_csr(partials, run_ptr.to(torch.int32))


def _cluster_sums(x: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """Each cluster's row sum in a fixed order, where ``index_add_``'s
    atomics on the card leave it open (and with it the centroids' last
    bits, from one process to the next). On the CPU the rows are summed in
    row order from 0 — the bits of ``index_add_`` there, and of the
    reference's ``segment_sum``, which the parity tests hold; on the card
    in ``run_sums``' order, for parallelism."""
    if x.device.type == "cuda":
        return run_sums(x, a, k)
    return segment_sum(x, a, k)


def fit(x: torch.Tensor, n_clusters: int, n_iters: int = 16, *,
        generator: Optional[torch.Generator] = None,
        init_idx: Optional[torch.Tensor] = None) -> KMeansState:
    """Lloyd's K-means (k-means++-lite seeding: random distinct samples).

    init_idx: optional (n_clusters,) row indices of the initial centroids;
    otherwise drawn from ``generator`` (CPU generator; distinct rows when
    n ≥ n_clusters, with replacement otherwise)."""
    n = x.shape[0]
    if init_idx is None:
        if n >= n_clusters:
            init_idx = torch.randperm(n, generator=generator)[:n_clusters]
        else:
            init_idx = torch.randint(n, (n_clusters,), generator=generator)
    cents = x[torch.as_tensor(init_idx, device=x.device).long()]
    counts = torch.zeros((n_clusters,), dtype=x.dtype, device=x.device)
    x = x.contiguous()
    for _ in range(n_iters):
        a = assign(x, cents)
        sums = _cluster_sums(x, a, n_clusters)
        # integers: exact in any order
        counts = torch.bincount(a, minlength=n_clusters).to(x.dtype)
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        # empty clusters keep their previous centroid
        cents = torch.where(counts[:, None] > 0, new, cents)
    a = assign(x, cents).long()
    d = x - cents[a]
    inertia = torch.mean(torch.sum(d * d, dim=-1))
    return KMeansState(centroids=cents, counts=counts, inertia=inertia)


# ---------------------------------------------------------------------------
# workload-aware repartitioning (paper §3.2: online adjustment on imbalance)
# ---------------------------------------------------------------------------

class WorkloadStats:
    """Host-side probe-frequency tracker. Search threads bump ``record``
    concurrently with writer-side ``reset``, so every touch of ``hits`` goes
    through ``_lock``; readers take ``hits_snapshot()``."""

    def __init__(self, n_partitions: int, imbalance_threshold: float = 4.0):
        self.hits = np.zeros(n_partitions, np.int64)
        self.threshold = imbalance_threshold
        self._lock = threading.Lock()

    def record(self, probed_partitions: np.ndarray):
        idx = np.asarray(probed_partitions).reshape(-1)
        with self._lock:
            np.add.at(self.hits, idx, 1)

    def hits_snapshot(self) -> np.ndarray:
        with self._lock:
            return self.hits.copy()

    def load_hits(self, hits: np.ndarray) -> None:
        with self._lock:
            self.hits = np.asarray(hits, np.int64).copy()

    @property
    def imbalance(self) -> float:
        with self._lock:
            hits = self.hits.copy()
        mean = hits.mean() + 1e-9
        return float(hits.max() / mean)

    def should_repartition(self) -> bool:
        with self._lock:
            hits = self.hits.copy()
        mean = hits.mean() + 1e-9
        return hits.sum() > 0 and float(hits.max() / mean) > self.threshold

    def reset(self):
        with self._lock:
            self.hits[:] = 0


def split_two(members: torch.Tensor, n_iters: int = 8, *,
              generator: Optional[torch.Generator] = None,
              init_idx: Optional[torch.Tensor] = None):
    """K=2 Lloyd's fit over one partition's members — the local step behind
    an incremental split (``maintenance/executor.py``). Returns
    ``(centroids (2, d), assignment (n,))``; only the members move, never
    the rest of the corpus. ``init_idx`` / ``generator`` seed the fit as in
    ``fit``."""
    sub = fit(members, 2, n_iters, generator=generator, init_idx=init_idx)
    return sub.centroids, assign(members, sub.centroids)


def split_hot_partition(x: torch.Tensor, state: KMeansState, hot: int, *,
                        generator: Optional[torch.Generator] = None,
                        init_idx: Optional[torch.Tensor] = None
                        ) -> KMeansState:
    """Legacy stop-the-world split: re-fit K=2 on the hot partition's
    members and overwrite the (hot, coldest) centroids; the caller then
    rebuilds the whole slab against the new centroid set. Superseded by the
    bounded-work split in ``maintenance.executor`` (which moves only the
    hot partition's rows, byte-identically) — kept as the reference
    implementation."""
    a = assign(x, state.centroids)
    members = x[a == hot]
    if members.shape[0] < 2:
        return state
    sub = fit(members, 2, 8, generator=generator, init_idx=init_idx)
    cents = state.centroids.clone()
    cold = int(torch.argmin(state.counts))
    cents[hot] = sub.centroids[0]
    cents[cold] = sub.centroids[1]
    return KMeansState(cents, state.counts, state.inertia)
