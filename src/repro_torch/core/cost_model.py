"""Learned cost model and plan selection (paper Eq. 5 + §3.6).

    C = α·log N + β·(d·h) + γ·p·log(N/p)

α, β, γ are calibrated by least squares against measured query latencies
(the benchmark harness emits (features, latency) pairs). ``select_plan``
greedily picks the cheapest plan satisfying the recall constraint — the
paper's "greedy plan selection with optimality bounds".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CostModel:
    alpha: float = 1.0
    beta: float = 0.01
    gamma: float = 0.1

    def cost(self, n: int, d: int, h: int, p: int) -> float:
        """Eq. 5. n=corpus size, d=dim, h=hops, p=partitions probed."""
        p = max(p, 1)
        return (self.alpha * math.log(max(n, 2))
                + self.beta * (d * h)
                + self.gamma * p * math.log(max(n / p, 2)))

    def features(self, n, d, h, p) -> np.ndarray:
        p = max(p, 1)
        return np.array([math.log(max(n, 2)), d * h, p * math.log(max(n / p, 2))])

    def fit(self, samples: Sequence[Tuple[int, int, int, int]],
            latencies: Sequence[float]) -> "CostModel":
        """Least-squares calibration of (α, β, γ) on measured latencies."""
        X = np.stack([self.features(*s) for s in samples])
        y = np.asarray(latencies, np.float64)
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        self.alpha, self.beta, self.gamma = (float(c) for c in coef)
        return self

    def r2(self, samples, latencies) -> float:
        X = np.stack([self.features(*s) for s in samples])
        y = np.asarray(latencies, np.float64)
        pred = X @ np.array([self.alpha, self.beta, self.gamma])
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2)) + 1e-12
        return 1.0 - ss_res / ss_tot


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    name: str
    n_probe: int
    n_hops: int
    use_nsw_refine: bool = False
    use_rerank: bool = False
    expected_recall: float = 0.9


DEFAULT_PLANS: Tuple[QueryPlan, ...] = (
    QueryPlan("vector_fast", n_probe=2, n_hops=0, expected_recall=0.80),
    QueryPlan("vector_std", n_probe=8, n_hops=0, expected_recall=0.95),
    QueryPlan("hybrid_1hop", n_probe=4, n_hops=1, expected_recall=0.93),
    QueryPlan("hybrid_2hop", n_probe=8, n_hops=2, expected_recall=0.97),
    QueryPlan("hybrid_deep", n_probe=16, n_hops=3, use_rerank=True,
              expected_recall=0.99),
)


def select_plan(model: CostModel, *, n: int, d: int, min_recall: float,
                plans: Sequence[QueryPlan] = DEFAULT_PLANS) -> QueryPlan:
    """Greedy: cheapest plan whose expected recall clears the floor."""
    feasible = [p for p in plans if p.expected_recall >= min_recall]
    if not feasible:
        feasible = [max(plans, key=lambda p: p.expected_recall)]
    return min(feasible, key=lambda p: model.cost(n, d, p.n_hops, p.n_probe))


# ---------------------------------------------------------------------------
# attribute-filtered search planning (pre-filter pushdown vs oversample)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FilteredScanPlan:
    """How to serve "top-k WHERE pred": push the predicate into the scan's
    validity mask ("prefilter") or run the unfiltered scan with an inflated
    k and post-filter ("oversample")."""
    mode: str                 # "prefilter" | "oversample"
    k_scan: int               # top-k width handed to the underlying scan
    selectivity: float


def estimate_selectivity(node_pass) -> float:
    """Fraction of rows a predicate admits — one mean over the (N,) mask the
    predicate compiler already produced (exact, not a sketch: attributes are
    resident on device and the mask is reused by every scan stage)."""
    return float(np.mean(np.asarray(node_pass)))


def plan_filtered_scan(selectivity: float, k: int, *, n_rows: int,
                       oversample: float = 3.0,
                       prefilter_max_sel: float = 0.5) -> FilteredScanPlan:
    """Selectivity-aware choice (the NHQ observation, inverted per regime):

    - Low selectivity (few rows pass): post-filtering is hopeless — the
      unfiltered top-k' must be ~k/sel wide before k survivors show up, so
      its top-k sort cost (and exactness risk) blows up as 1/sel. Pushdown
      scans the same rows but spends every top-k slot on qualifying rows.
    - Selectivity near 1: almost everything passes; a small constant
      oversample (k' = oversample·k/sel) already contains the filtered top-k
      with high probability, and skips the per-row mask gather the pushdown
      folds into the scan's valid lane.

    The crossover is where the oversampled width stops being "small":
    k/sel·oversample ≳ the pushdown's masked width ⇒ prefilter below
    ``prefilter_max_sel``, oversample above. k_scan for oversampling is the
    *initial* width — exactness-sensitive callers double it until k
    survivors are found (see HMGIIndex.search)."""
    sel = float(min(max(selectivity, 0.0), 1.0))
    if sel <= 0.0:
        return FilteredScanPlan("prefilter", k, 0.0)
    if sel <= prefilter_max_sel:
        return FilteredScanPlan("prefilter", k, sel)
    k_scan = min(n_rows, max(k + 1, int(math.ceil(k * oversample / sel))))
    return FilteredScanPlan("oversample", k_scan, sel)


# ---------------------------------------------------------------------------
# device layout planning (single-device vs row-sharded stable scan)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceLayoutPlan:
    """Where a modality's stable scan runs: "single" (one device holds the
    whole slab) or "sharded" (row-sharded over the mesh's db axes, per-shard
    probes + cross-shard top-k merge — see ivf.shard_index)."""
    layout: str               # "single" | "sharded"
    n_shards: int             # 1 for "single"


def plan_device_layout(n_rows: int, dim: int, *, n_shards: int,
                       budget_bytes: int, bytes_per_elem: int = 1,
                       force: Optional[str] = None) -> DeviceLayoutPlan:
    """Shard the stable scan when one device's slab share would exceed the
    per-device budget (n_rows·dim quantized bytes — the HBM-residency the
    probe path actually touches), single-device otherwise. Sharding below
    that is pure overhead: the probe scan is already one device's flops, and
    the cross-shard all-gather+merge adds a collective per query.

    force: "single"/"sharded" overrides the decision (cfg.shard_layout);
    forcing "sharded" on a 1-shard mesh still degenerates to "single"."""
    if force not in (None, "auto", "single", "sharded"):
        raise ValueError(f"unknown layout {force!r}")
    if n_shards <= 1 or force == "single":
        return DeviceLayoutPlan("single", 1)
    if force == "sharded":
        return DeviceLayoutPlan("sharded", n_shards)
    slab_bytes = n_rows * dim * bytes_per_elem
    if budget_bytes > 0 and slab_bytes > budget_bytes:
        return DeviceLayoutPlan("sharded", n_shards)
    return DeviceLayoutPlan("single", 1)


# ---------------------------------------------------------------------------
# query-engine stage planning (repro_torch/query/planner.py consumes these)
# ---------------------------------------------------------------------------

def plan_seed_width(k: int, downstream: bool) -> int:
    """Scan width for a vector-seed stage: the bare top-k when the seeds are
    the answer; oversampled (fusion/re-score headroom, the facade's historic
    2k ∨ k+8 rule) when later stages re-rank or combine them."""
    return max(2 * k, k + 8) if downstream else k


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Shape of a traversal-fusion stage: candidate-sparse (fuse over the
    seeds ∪ frontier union, O(Q·C) memory) vs dense (fuse over all N nodes).

    Sparse wins whenever the frontier is a strict subset of the corpus — its
    peak memory is corpus-size independent and its exactness argument holds
    (frontier = k_fuse + C_in). When ``frontier`` reaches ``n_nodes`` the
    candidate union already spans every node, so the sparse bookkeeping
    (dup masks, concat lanes) buys nothing over one dense scatter."""
    repr: str                 # "sparse" | "dense"
    k_fuse: int               # fused candidates kept (stage output width)
    frontier: int             # traversal nodes admitted to the candidate set


def plan_fusion(n_nodes: int, k: int, c_in: int) -> FusionPlan:
    """c_in = incoming candidate-set width (the seed stage's scan width)."""
    k_fuse = max(k, min(4 * k, n_nodes))
    frontier = int(min(n_nodes, k_fuse + c_in))
    return FusionPlan("dense" if frontier >= n_nodes else "sparse",
                      k_fuse, frontier)


# ---------------------------------------------------------------------------
# adaptive index maintenance planning (maintenance/executor.py consumes this)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaintenanceAction:
    """One bounded-work maintenance step the executor can apply.

    kind ∈ {"compact_chunk", "split_hot", "merge_cold", "recluster"};
    ``rows`` is the estimated work (slab/delta rows touched — the budget
    currency), ``benefit`` the estimated per-query saving in scanned-row
    units (see ``plan_maintenance`` for the per-action model)."""
    kind: str
    partition: int = -1
    rows: int = 0
    benefit: float = 0.0

    def describe(self) -> str:
        p = "" if self.partition < 0 else f" p={self.partition}"
        return (f"{self.kind}[{self.rows} rows{p} "
                f"benefit={self.benefit:.1f}]")


@dataclasses.dataclass(frozen=True)
class MaintenanceSummary:
    """Per-partition statistics snapshot ``plan_maintenance`` decides from
    (assembled by maintenance/stats.py from its write-time accumulators)."""
    live: np.ndarray          # (K,) live (visible) rows per partition
    free: np.ndarray          # (K,) empty slots per partition
    heat: np.ndarray          # (K,) probe hits since the last plan
    dead: np.ndarray          # (K,) tombstoned/superseded stable rows
    drift: np.ndarray         # (K,) mean assigned-distance growth vs build
                              #      (0 = no drift, 0.5 = +50%)
    parked: np.ndarray        # (K,) bool — merged-away partitions
    delta_live: int           # live rows in the delta store
    delta_used: int           # append watermark (slots consumed)
    delta_capacity: int
    cap: int                  # per-partition slot capacity


def plan_maintenance(summary: MaintenanceSummary, *, budget_rows: int,
                     chunk: int, need_rows: int = 0,
                     delta_pressure: float = 0.5,
                     heat_imbalance: float = 4.0,
                     split_min_fill: float = 0.75,
                     merge_max_fill: float = 0.10,
                     drift_threshold: float = 0.35
                     ) -> List[MaintenanceAction]:
    """Cost-driven maintenance policy: choose the bounded-work actions worth
    their cost, greedily by benefit/row under ``budget_rows``.

    Per-action benefit model (scanned-row units per future query — the same
    currency Eq. 5's γ term prices):

    - **compact_chunk** — every query scans the whole delta, so draining
      ``r`` slots saves ``r`` scanned rows per query. Triggered when the
      delta's append watermark passes ``delta_pressure`` of capacity, or
      unconditionally when the caller must free ``need_rows`` slots for a
      pending insert (never drop a write).
    - **merge_cold** — a partition whose live fill sank below
      ``merge_max_fill`` (deletes/updates hollowed it out) still costs a
      full ``cap``-row scan whenever probed; folding its survivors into the
      nearest sibling retires that scan and frees the slot for a future
      split. Benefit: its probe share × cap + the dead rows removed.
    - **split_hot** — the probe-heat tracker shows one partition absorbing
      ≥ ``heat_imbalance``× the mean probe traffic while ≥ ``split_min_fill``
      full: its crowded slab degrades recall-per-probe and its overflow
      pressures the delta. Splitting halves the hot slab's crowding for its
      (dominant) probe share. Requires a parked partition or a viable merge
      to free one — the planner emits that merge first.
    - **recluster** — a partition whose incoming rows land ``drift_threshold``
      further from the centroid than the build-time baseline routes future
      probes badly; re-centering (no row moves) restores routing for its
      probe share.

    Returns actions in execution order; empty list = no-op. Estimates only —
    the executor re-validates feasibility (e.g. sibling capacity) at apply
    time."""
    K = len(summary.live)
    total_heat = float(summary.heat.sum()) or 1.0
    heat_frac = summary.heat / total_heat
    candidates: List[MaintenanceAction] = []

    # --- delta drain ------------------------------------------------------
    # forced chunks free exactly the slots a pending insert needs (every
    # drain step also reclaims stale/dead watermark slack via the rebuild);
    # draining the whole delta on a forced call would reinstate the very
    # full-compaction stall this subsystem removes. Pressure-driven chunks
    # beyond that compete under the budget like any other action.
    force = max(0, int(need_rows))
    n_forced = -(-force // max(chunk, 1))
    fill = summary.delta_used / max(summary.delta_capacity, 1)
    for _ in range(n_forced):
        candidates.append(MaintenanceAction("compact_chunk", -1, chunk,
                                            benefit=float(chunk)))
    if fill >= delta_pressure:
        if summary.delta_live == 0 and summary.delta_used and not n_forced:
            # pure dead weight (e.g. everything inserted was deleted): one
            # chunk reclaims the whole watermark via the drain's rebuild
            candidates.append(MaintenanceAction(
                "compact_chunk", -1, 1, benefit=float(summary.delta_used)))
        drain = summary.delta_live - n_forced * chunk
        while drain > 0:
            r = min(chunk, drain)
            candidates.append(MaintenanceAction("compact_chunk", -1, r,
                                                benefit=float(r)))
            drain -= r

    # --- merge-cold -------------------------------------------------------
    live_parts = ~summary.parked
    n_live_parts = int(live_parts.sum())
    mergeable = []
    for p in range(K):
        if summary.parked[p] or n_live_parts <= 1:
            continue
        fill_p = summary.live[p] / max(summary.cap, 1)
        if summary.live[p] == 0 or fill_p <= merge_max_fill:
            b = heat_frac[p] * summary.cap + float(summary.dead[p])
            mergeable.append(MaintenanceAction(
                "merge_cold", p, rows=max(int(summary.live[p]), 1),
                benefit=float(b)))
    mergeable.sort(key=lambda a: a.benefit / a.rows, reverse=True)
    candidates.extend(mergeable)

    # --- split-hot --------------------------------------------------------
    if n_live_parts > 1 and total_heat > 1.0:
        mean_heat = total_heat / max(n_live_parts, 1)
        # a parked partition's accumulated (pre-merge) hits must not win
        # the argmax and suppress splits of genuinely hot live partitions
        hot = int(np.argmax(np.where(summary.parked, -1, summary.heat)))
        if (summary.heat[hot] > heat_imbalance * mean_heat
                and summary.live[hot] >= split_min_fill * summary.cap):
            rows = int(summary.live[hot])
            b = heat_frac[hot] * rows / 2.0
            free_slot = bool(summary.parked.any())
            if not free_slot and not any(a.kind == "merge_cold"
                                         for a in candidates):
                # a split needs an empty partition: free the best merge
                # candidate first even if it didn't clear its own threshold
                others = [p for p in range(K)
                          if p != hot and not summary.parked[p]]
                cold = min(others, key=lambda p: summary.live[p])
                candidates.append(MaintenanceAction(
                    "merge_cold", cold,
                    rows=max(int(summary.live[cold]), 1),
                    benefit=float(b) / 2))
            candidates.append(MaintenanceAction("split_hot", hot, rows,
                                                benefit=float(b)))

    # --- recluster --------------------------------------------------------
    for p in range(K):
        if summary.parked[p] or summary.live[p] == 0:
            continue
        if summary.drift[p] >= drift_threshold:
            candidates.append(MaintenanceAction(
                "recluster", p, rows=max(int(summary.live[p]), 1),
                benefit=float(heat_frac[p] * summary.drift[p]
                              * summary.live[p])))

    # --- greedy selection under the row budget ----------------------------
    # the n_forced need_rows chunks (emitted first) are mandatory — a
    # dropped write is not a cost decision; everything else competes on
    # benefit/row, and at least one triggered action always runs (budget
    # floors, never zeroes)
    mandatory = candidates[:n_forced]
    optional = candidates[n_forced:]
    optional.sort(key=lambda a: a.benefit / max(a.rows, 1), reverse=True)
    chosen: List[MaintenanceAction] = list(mandatory)
    spent = sum(a.rows for a in chosen)
    for a in optional:
        if chosen and spent + a.rows > budget_rows:
            continue
        chosen.append(a)
        spent += a.rows
    # execution order: drain first (frees delta slots), then merges (free a
    # partition), then splits (consume one), then reclusters. The executor
    # re-validates feasibility (sibling capacity, parked-slot availability)
    # at apply time, so a budget-dropped enabling merge degrades a split to
    # a no-op rather than a fault.
    rank = {"compact_chunk": 0, "merge_cold": 1, "split_hot": 2,
            "recluster": 3}
    chosen.sort(key=lambda a: rank[a.kind])
    return chosen
