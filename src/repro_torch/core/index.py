"""HMGIIndex — the unified facade (paper Fig. 1): modality-aware partitioned
vector indexes + knowledge-graph store + MVCC delta + hybrid fusion engine,
behind one ingest/search/update API, on one CUDA device.

``HMGIIndex(cfg)`` runs on the card and raises when there is none; only an
explicit ``device="cpu"`` runs on the CPU, where the scan kernels' plain
versions take their place. Ids are global graph-node ids across all
modalities, so vector hits seed traversals directly.

Writes take the paper's adaptive path: write-time partition statistics
(``maintenance.PartitionStats``) feed ``maintain``, which applies bounded
drains, merges, splits and reclusters as slot surgery; with
``cfg.maint_auto`` (the default) ``insert`` and ``delete`` trigger it, and
``compact`` stays the stop-the-world fallback.

The optional lanes are the reference's: an NSW graph that refines every
seed scan (``cfg.use_nsw_refine``, ``core/nsw.py``) and a sparse-dense
rerank of the fused set (``set_sparse_docs``, ``core/rerank.py``). Spans
(``repro_torch.obs``) time each stage; ``trace=True`` returns their tree.

Durability lives outside the facade: ``repro_torch.persistence``'s
``DurableHMGIIndex`` logs every mutation to a write-ahead log before
applying it, snapshots ``state_tree`` and recovers with ``recover``.

Not ported yet: a device mesh and ``device_layout`` (ROADMAP Queue 1 item
15), refused with ``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.common.params import resolve_device
from repro_torch.common.reduce import row_sum
from repro_torch.common.topk import top_k
from repro_torch.configs.base import HMGIConfig
from repro_torch.core import community as comm_mod
from repro_torch.core import delta as delta_mod
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import nsw as nsw_mod
from repro_torch.core import partitioner
from repro_torch.core import rerank as rerank_mod
from repro_torch.core.cost_model import (CostModel, plan_maintenance,
                                         select_plan)
from repro_torch.core.fusion import FusionWeights, fuse_topk_sparse
from repro_torch.core.graph_store import (GraphStore, NodeAttributes,
                                          from_edges as graph_from_edges,
                                          mask_pass)
from repro_torch.core.partitioner import WorkloadStats
from repro_torch.core.quantization import AdaptiveQuantPolicy
from repro_torch.maintenance import MaintenanceReport, PartitionStats

# repro_torch.query (planner/executor) imports core submodules at module
# scope, so the facade imports it inside methods; the maintenance executor
# is imported there too.


# the host-side PartitionStats arrays a snapshot carries
_STATS_FIELDS = ("baseline", "drift_sum", "drift_cnt", "dead", "parked")


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md Queue 1 item {item})")


def _fuse_candidates(vs, vi, graph_scores, wv, wg, *, k_fuse: int,
                     frontier: int, node_pass=None):
    """Candidate-sparse fusion stage (Eq. 3): fuse over the union of the
    ANNS seeds ``vi`` and the ``frontier`` strongest traversal nodes instead
    of scattering into a dense (Q, n_nodes) similarity array.

    Exactness: a node outside the union that dense fusion would rank in its
    top-k_fuse has no vector term, so its fused score is monotone in its
    graph mass — but ≥ k_fuse non-seed nodes inside the frontier carry at
    least as much mass (frontier = k_fuse + k_seed), so it can never
    displace the union's top-k_fuse. The graph normaliser is the frontier's
    top-1 = the global max.

    node_pass: optional (N,) bool predicate mask — excluded nodes are struck
    from both the seed and frontier candidate lanes."""
    g_vals, g_ids = top_k(graph_scores, frontier)                   # (Q, F)
    g_ids = g_ids.to(torch.int32)
    n_nodes = graph_scores.shape[1]
    vi = vi.to(torch.int32)
    # drop repeated seed ids: keep the first = highest-scored occurrence
    ks = vi.shape[1]
    earlier = torch.tril(torch.ones((ks, ks), dtype=torch.bool,
                                    device=vi.device), diagonal=-1)
    seed_dup = ((vi[:, :, None] == vi[:, None, :]) & earlier).any(dim=-1)
    seed_valid = (vi >= 0) & ~seed_dup
    front_valid = torch.ones(g_ids.shape, dtype=torch.bool, device=vi.device)
    if node_pass is not None:
        seed_valid = seed_valid & mask_pass(node_pass, vi)
        front_valid = mask_pass(node_pass, g_ids)
    g_at_vi = torch.gather(graph_scores, 1, vi.clamp(0, n_nodes - 1).long())
    # frontier entries already present as seeds fuse through the seed copy
    dup = (g_ids[:, :, None]
           == torch.where(seed_valid, vi, -2)[:, None, :]).any(dim=-1)
    ninf = float("-inf")
    cand_ids = torch.cat([torch.where(seed_valid, vi, -1), g_ids], dim=1)
    cand_sim = torch.cat([torch.where(seed_valid, vs, ninf),
                          torch.full_like(g_vals, ninf)], dim=1)
    cand_graph = torch.cat([torch.where(seed_valid, g_at_vi, 0.0),
                            torch.where(dup, 0.0, g_vals)], dim=1)
    cand_valid = torch.cat([seed_valid, ~dup & front_valid], dim=1)
    fvals, fpos = fuse_topk_sparse(cand_sim, cand_graph, FusionWeights(wv, wg),
                                   k_fuse, graph_max=g_vals[:, :1],
                                   valid=cand_valid)
    return fvals, torch.gather(cand_ids, 1, fpos)


@dataclasses.dataclass
class ModalityIndex:
    ivf: ivf_mod.IVFIndex
    delta: delta_mod.DeltaStore
    vectors: torch.Tensor       # fp32 master copy (compaction, NSW, cross-modal)
    ids: torch.Tensor           # (N,) global node ids
    nsw: Optional[nsw_mod.NSWGraph] = None
    workload: Optional[WorkloadStats] = None
    # write-time per-partition maintenance statistics (heat lives in
    # ``workload``; this adds delta pressure, tombstone ratio, drift) —
    # consumed by cost_model.plan_maintenance via HMGIIndex.maintain
    stats: Optional[PartitionStats] = None
    # True once any delete/update touched this modality: gates the MVCC
    # visibility pushdown in the scan (never reset — conservative)
    has_dead: bool = False
    # (n_nodes,) global-id -> row cache for cross-modal re-scoring; rebuilt
    # lazily, invalidated when ``ids`` gains new entries
    id_rows: Optional[torch.Tensor] = None


class HMGIIndex:
    """The Hybrid Multimodal Graph Index.

    Thread-safety: searches are safe from any number of threads,
    concurrently with at most one mutating caller. ``_write_lock``
    serialises every mutation and the state_tree snapshot; ``_cache_lock``
    guards the lazily-built ``ModalityIndex.id_rows``.

    The random draws of ingest, compaction and maintenance (K-means
    seeding, the NSW build's) come from a ``torch.Generator`` seeded with
    ``seed``; they differ from the reference's ``jax.random`` draws for the
    same seed."""

    def __init__(self, cfg: HMGIConfig, mesh=None, seed: int = 0, *,
                 device=None):
        if mesh is not None:
            raise _todo("a device mesh (row-sharded search)", "15")
        self.cfg = cfg
        self.device = resolve_device(device, "HMGIIndex")
        self.seed = int(seed)
        self.generator = torch.Generator().manual_seed(self.seed)
        self._write_lock = threading.RLock()   # serialises mutations
        self._cache_lock = threading.Lock()    # guards lazy read caches
        self.modalities: Dict[str, ModalityIndex] = {}
        self.graph: Optional[GraphStore] = None
        self.attributes: Optional[NodeAttributes] = None
        self.communities: Optional[np.ndarray] = None
        self.boosted_weights: Optional[torch.Tensor] = None
        self.sparse_docs: Optional[rerank_mod.SparseVectors] = None
        self.cost_model = CostModel(cfg.cost_alpha, cfg.cost_beta, cfg.cost_gamma)
        self.quant_policy = AdaptiveQuantPolicy(cfg.memory_budget_bytes)
        self.n_nodes = 0
        self._metrics: Dict[str, object] = {}
        # monotone mutation stamp: bumped by every change that can alter a
        # search result
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def _bump_version(self) -> None:
        self._version += 1

    def _tensor(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ build
    def ingest(self, embeddings: Dict[str, Tuple[np.ndarray, np.ndarray]],
               n_nodes: int, edges: Optional[Tuple] = None,
               build_nsw: bool = False,
               node_attrs: Optional[Dict[str, np.ndarray]] = None):
        """Builds the index over a multimodal corpus.

        embeddings: modality -> (node_ids (N_m,) int, vectors (N_m, d_m));
        vectors are L2-normalised here. edges: (src, dst[, edge_type[,
        edge_weight]]) arrays over global node ids. node_attrs: column name
        -> (n_nodes,) int values. Build overflow (rows beyond a partition's
        capacity) is routed to the delta store — grown if needed, never
        dropped. build_nsw (or ``cfg.use_nsw_refine``): also build each
        modality's NSW graph.

        The seconds each stage took (the device synchronised at each
        boundary) land in ``metrics()["ingest_seconds"]``."""
        with self._write_lock:
            self._ingest_locked(embeddings, n_nodes, edges, build_nsw,
                                node_attrs)

    def _build_nsw(self, vectors: torch.Tensor) -> nsw_mod.NSWGraph:
        return nsw_mod.build(
            vectors, degree=min(self.cfg.nsw_degree, vectors.shape[0] - 1),
            generator=self.generator)

    def _ingest_locked(self, embeddings, n_nodes, edges, build_nsw,
                       node_attrs):
        clock = {"to_device": 0.0, "kmeans": 0.0, "layout": 0.0,
                 "nsw": 0.0, "graph": 0.0, "louvain": 0.0}

        def lap(stage, t0):
            self._sync()
            t1 = time.perf_counter()
            clock[stage] += t1 - t0
            return t1

        self.n_nodes = n_nodes
        cfg = self.cfg
        for mod, (ids, vecs) in embeddings.items():
            t = time.perf_counter()
            vecs = self._tensor(vecs, torch.float32)
            ids = self._tensor(ids, torch.int32)
            t = lap("to_device", t)
            vecs = vecs / torch.clamp_min(
                torch.linalg.vector_norm(vecs, dim=-1, keepdim=True), 1e-12)
            bits = self.quant_policy.choose_bits(
                int(vecs.numel() * 4), default_bits=cfg.quant_bits)
            k = min(cfg.n_partitions, vecs.shape[0])
            cents = partitioner.fit(vecs, k, cfg.kmeans_iters,
                                    generator=self.generator).centroids
            t = lap("kmeans", t)
            index, overflow = ivf_mod.build(vecs, ids, n_partitions=k,
                                            bits=bits, centroids=cents)
            dstore = delta_mod.init(cfg.delta_capacity, vecs.shape[1],
                                    max(n_nodes, 1), self.device)
            if bool(overflow.any()):
                ov = torch.nonzero(overflow).flatten()
                dstore = delta_mod.insert_grow(dstore, vecs[ov], ids[ov])
            m = ModalityIndex(
                ivf=index, delta=dstore, vectors=vecs, ids=ids,
                workload=WorkloadStats(k),
                stats=PartitionStats.from_build(vecs, ids, index,
                                                max_ids=max(n_nodes, 1)))
            t = lap("layout", t)
            if build_nsw or cfg.use_nsw_refine:
                m.nsw = self._build_nsw(vecs)
                lap("nsw", t)
            self.modalities[mod] = m
        if edges is not None:
            t = time.perf_counter()
            src, dst = np.asarray(edges[0]), np.asarray(edges[1])
            et = edges[2] if len(edges) > 2 else None
            ew = edges[3] if len(edges) > 3 else None
            self.graph = graph_from_edges(n_nodes, src, dst, et, ew,
                                          device=self.device)
            t = lap("graph", t)
            self.communities = comm_mod.louvain_one_level(
                n_nodes, src, dst,
                np.ones(len(src)) if ew is None else np.asarray(ew))
            self.boosted_weights = comm_mod.community_edge_boost(
                self.graph, self.communities)
            lap("louvain", t)
        self._metrics["ingest_seconds"] = clock
        if node_attrs is not None:
            self.set_attributes(node_attrs)
        self._bump_version()

    def set_attributes(self, node_attrs: Dict[str, np.ndarray]):
        """Attach/replace the relational attribute columns (global node id
        keyed). Swapping columns changes every filtered result, so it bumps
        the version stamp."""
        with self._write_lock:
            self.attributes = NodeAttributes.from_columns(
                self.n_nodes, node_attrs, device=self.device)
            self._bump_version()

    def set_sparse_docs(self, docs: rerank_mod.SparseVectors):
        """Attach/replace the hashed-term documents of the rerank lane:
        (n_nodes, nnz) term ids (-1 padded) and weights, indexed by global
        node id. Swapping them changes reranked results, so it bumps the
        version stamp."""
        with self._write_lock:
            self.sparse_docs = rerank_mod.SparseVectors(
                term_ids=self._tensor(docs.term_ids, torch.int32),
                term_weights=self._tensor(docs.term_weights, torch.float32))
            self._bump_version()

    def device_layout(self, modality: str):
        raise _todo("device layouts over a mesh (device_layout)", "15")

    # ----------------------------------------------------------------- search
    def _norm_queries(self, queries) -> torch.Tensor:
        """Unit rows; the norm sums each row in ``row_sum``'s order, so a
        query's bits do not depend on its batch."""
        q = self._tensor(queries, torch.float32)
        return q / torch.clamp_min(row_sum(q * q).sqrt()[:, None], 1e-12)

    def _node_pass(self, where) -> Optional[torch.Tensor]:
        """Compiles a where clause against the attribute store -> (N,) bool."""
        if where is None:
            return None
        if self.attributes is None:
            raise ValueError("filtered search needs attributes: call "
                             "set_attributes() or ingest(node_attrs=...)")
        return self.attributes.node_pass(where)

    def _modality_id_rows(self, modality: str) -> torch.Tensor:
        """The (n_nodes,) global-id -> row map for cross-modal re-scoring,
        built lazily once per (modality, corpus size); double-checked under
        ``_cache_lock``."""
        m = self.modalities[modality]
        rows = m.id_rows
        if rows is not None and rows.shape[0] == self.n_nodes:
            return rows
        with self._cache_lock:
            rows = m.id_rows
            if rows is None or rows.shape[0] != self.n_nodes:
                from repro_torch.query.executor import _modality_rows
                rows = _modality_rows(m.ids, self.n_nodes)
                m.id_rows = rows
            return rows

    def query(self, plan, *, trace: bool = False):
        """Runs a declarative plan (see ``repro_torch.query.Q``): compiles
        it cost-wise against this index and executes it stage by stage.
        Returns (scores (Q, k), ids (Q, k)); with ``trace=True``, (scores,
        ids, trace) where ``trace.render()`` is the per-stage span tree."""
        from repro_torch.query.executor import execute
        from repro_torch.query.planner import compile_plan
        obs.set_sync_spans(self.cfg.obs_sync_spans)
        with self._maybe_trace(trace) as t:
            out = execute(self, compile_plan(self, plan))
        return out + (t,) if trace else out

    @staticmethod
    def _maybe_trace(trace: bool):
        """``obs.trace()`` collector when tracing, else a null context —
        untraced queries skip span-tree assembly (spans still feed the
        registry histograms)."""
        return obs.trace() if trace else contextlib.nullcontext()

    def explain(self, plan) -> str:
        """The compiled physical plan for ``plan``, as a one-line string."""
        from repro_torch.query.planner import compile_plan
        return compile_plan(self, plan).describe()

    def search(self, queries, modality: str, k: Optional[int] = None,
               n_probe: Optional[int] = None, where=None, impl: str = "auto",
               *, trace: bool = False, _node_pass=None):
        """Pure vector search (ANNS on stable index + delta), tombstone-aware:
        the one-stage plan ``Q.vector(modality, queries).where(where)
        .topk(k)``. where: optional relational predicate — a (column, op,
        value) tuple or a list of them (AND); the planner picks pushdown or
        oversample-then-post-filter from its selectivity.

        trace: when True, returns (scores, ids, trace) — ``trace.render()``
        prints the per-stage span tree (plan, seed scan, ...)."""
        from repro_torch.query.ast import Q
        from repro_torch.query.executor import execute
        from repro_torch.query.planner import compile_plan
        obs.set_sync_spans(self.cfg.obs_sync_spans)
        plan = Q.vector(modality, queries, n_probe=n_probe,
                        impl=impl).where(where)
        with self._maybe_trace(trace) as t:
            phys = compile_plan(self, plan, k=k or self.cfg.top_k,
                                node_pass=_node_pass)
            out = execute(self, phys)
        return out + (t,) if trace else out

    def hybrid_search(self, queries, modality: str, k: Optional[int] = None,
                      n_hops: Optional[int] = None,
                      n_probe: Optional[int] = None,
                      edge_type_mask=None,
                      where=None,
                      min_recall: Optional[float] = None,
                      use_rerank: bool = False,
                      q_terms=None, q_term_weights=None, *,
                      trace: bool = False):
        """The paper's hybrid query (Eq. 3): ANNS seeds -> h-hop traversal
        -> adaptive fusion -> (optional sparse-dense rerank). Returns
        (scores, ids); with ``trace=True``, (scores, ids, trace). ``where``
        holds at every stage: seed search, traversal routing and fusion
        candidates.

        use_rerank: with ``set_sparse_docs`` done, ``n_hops > 0`` and
        ``q_terms`` ((T,) hashed term ids for the batch, ``q_term_weights``
        (T,)), the untruncated fused set is re-ranked by reciprocal-rank
        fusion of its dense order and its sparse term overlap; the scores
        are then the RRF values."""
        from repro_torch.query.ast import Q
        from repro_torch.query.executor import execute
        from repro_torch.query.planner import compile_plan
        if self.graph is None:
            raise ValueError("hybrid_search needs a graph: ingest(edges=...)")
        obs.set_sync_spans(self.cfg.obs_sync_spans)
        cfg = self.cfg
        k = k or cfg.top_k
        if min_recall is not None:
            plan = select_plan(self.cost_model,
                               n=int(self.modalities[modality].ids.shape[0]),
                               d=int(self.modalities[modality].vectors.shape[1]),
                               min_recall=min_recall)
            n_probe = plan.n_probe
            n_hops = plan.n_hops
            use_rerank = use_rerank or plan.use_rerank
        n_hops = cfg.max_hops if n_hops is None else n_hops
        q = self._norm_queries(queries)

        with self._maybe_trace(trace) as t:
            plan = (Q.vector(modality, q, n_probe=n_probe)
                    .where(where)
                    .traverse(n_hops, edge_types=edge_type_mask))
            phys = compile_plan(self, plan, k=k, fusion_repr="sparse")
            fvals, fids = execute(self, phys, truncate=False)

            if (n_hops > 0 and use_rerank and self.sparse_docs is not None
                    and q_terms is not None):
                # optional sparse-dense rerank over the full fused set
                with obs.span("query.rescore") as span:
                    ss = rerank_mod.sparse_overlap_scores(
                        self.sparse_docs, self._tensor(q_terms, torch.int32),
                        self._tensor(q_term_weights, torch.float32), fids)
                    fvals, fids = span.fence(
                        rerank_mod.rrf_rerank(fvals, ss, fids, k=k))
                out = (fvals, fids)
            else:
                out = (fvals[:, :k], fids[:, :k])
        return out + (t,) if trace else out

    # ----------------------------------------------------------------- update
    def _record_dead(self, m: ModalityIndex, ids32: torch.Tensor):
        """Maintenance stats: ids whose stable row just became invisible
        (tombstoned or superseded). Counts only freshly dead ids — an id
        already hidden must not inflate the partition's dead counter."""
        if m.stats is None or not ids32.numel():
            return
        c = ids32.clamp(0, m.delta.tombstones.shape[0] - 1).long()
        fresh = ~(m.delta.tombstones[c] | m.delta.superseded[c])
        m.stats.record_dead(ids32[fresh].cpu().numpy(), m.ivf)

    def insert(self, modality: str, ids, vectors):
        """Insert-or-update a batch.

        ids: (B,) global node ids; vectors: (B, d_m) — L2-normalised here.
        Existing ids are superseded (MVCC update path): the stable row is
        hidden, the fp32 master row is rewritten in place, and the new
        version lands in the delta. When the delta lacks room (or crosses
        the compaction threshold), ``cfg.maint_auto`` routes the work
        through ``maintain`` — bounded incremental drains instead of a
        stop-the-world ``compact`` — growing the delta only if maintenance
        could not free enough slots. Writes are never dropped."""
        with obs.span("index.insert"), self._write_lock:
            self._insert_locked(modality, ids, vectors)

    def _insert_locked(self, modality: str, ids, vectors):
        m = self.modalities[modality]
        v = self._norm_queries(vectors)
        # free delta room BEFORE any visibility change: a forced drain here
        # still sees consistent MVCC state. Draining after supersede() would
        # move the id's *old* delta version into stable and clear its
        # superseded bit — then appending the new version would leave two
        # visible copies (the stale one served from stable).
        if delta_mod.free_slots(m.delta) < v.shape[0]:
            if self.cfg.maint_auto:
                self.maintain(modality, need_rows=v.shape[0]
                              - delta_mod.free_slots(m.delta))
            else:
                self._compact_locked(modality)
            m = self.modalities[modality]
        ids32 = self._tensor(ids, torch.int32)
        ids_np = ids32.cpu().numpy()
        existing_np = m.ids.cpu().numpy()
        # vectorized id -> row lookup (no host loop over the corpus)
        order = np.argsort(existing_np, kind="stable")
        sorted_ids = existing_np[order]
        pos = np.searchsorted(sorted_ids, ids_np)
        pos_c = np.minimum(pos, max(existing_np.size - 1, 0))
        upd_mask = (sorted_ids[pos_c] == ids_np) if existing_np.size \
            else np.zeros(ids_np.shape, bool)
        if upd_mask.any():
            upd = torch.as_tensor(upd_mask, device=self.device)
            m.has_dead = True
            self._record_dead(m, ids32[upd])
            m.delta = delta_mod.supersede(m.delta, ids32[upd])
            rows = torch.as_tensor(order[pos_c[upd_mask]], device=self.device)
            # in place: the master copy is this modality's own tensor
            m.vectors.index_copy_(0, rows, v[upd])
        if (~upd_mask).any():
            sel = torch.as_tensor(~upd_mask, device=self.device)
            m.vectors = torch.cat([m.vectors, v[sel]], dim=0)
            m.ids = torch.cat([m.ids, ids32[sel]])
            with self._cache_lock:
                m.id_rows = None    # new ids -> the row cache is stale
        # never drop writes: insert_grow widens the store if the (already
        # drained, above) delta still lacks room for the batch
        m.delta = delta_mod.insert_grow(m.delta, v, ids32)
        if m.stats is not None:
            a, d2 = partitioner.assign_with_distance(v, m.ivf.centroids)
            m.stats.record_writes(a.cpu().numpy(), d2.cpu().numpy())
        if delta_mod.should_compact(m.delta, self.cfg.compact_threshold):
            if self.cfg.maint_auto:
                self.maintain(modality)
            else:
                self._compact_locked(modality)
        self._bump_version()

    def delete(self, modality: str, ids):
        """Tombstones the ids in ``modality``: the rows vanish from every
        scan path at once and are purged by maintenance or compaction.
        With ``cfg.maint_auto`` a maintenance pass follows, so hollowed-out
        partitions eventually merge away."""
        with obs.span("index.delete"), self._write_lock:
            m = self.modalities[modality]
            ids32 = self._tensor(ids, torch.int32)
            self._record_dead(m, ids32)
            m.has_dead = True
            m.delta = delta_mod.delete(m.delta, ids32)
            self._bump_version()
            if self.cfg.maint_auto:
                self.maintain(modality)

    def compact(self, modality: str):
        """Full compaction: merge the whole delta into the stable store in
        one synchronous rebuild against the existing centroids. The adaptive
        path (``maintain`` / ``cfg.maint_auto``) drains the delta in bounded
        chunks instead; this stays the one-shot fallback."""
        with self._write_lock:
            self._compact_locked(modality)

    def _compact_locked(self, modality: str):
        m = self.modalities[modality]
        m.ivf, m.delta = delta_mod.compact(m.ivf, m.delta, m.vectors, m.ids)
        if m.stats is not None:
            # the rebuild dropped every dead stable row and re-packed slots
            m.stats.dead[:] = 0
            m.stats.invalidate_slab()
        if m.nsw is not None:
            # compaction clears the superseded mask, which is what hid
            # updated rows from the NSW lane — refresh it over the latest
            # vectors or it would serve pre-update similarities again
            m.nsw = self._build_nsw(m.vectors)
        self._bump_version()

    def maybe_repartition(self, modality: str) -> bool:
        """Workload-aware online adjustment (paper §3.2), as bounded work.

        When the probe-heat tracker reports imbalance, the hottest
        partition is split in place by the maintenance executor: a local
        K=2 fit over that partition's stored rows, moved byte-identically
        between the hot slab and a freed partition (merging the coldest
        away first when none is parked). Only the hot partition's rows move
        — no full rebuild, and survivors that don't fit anywhere are routed
        to the delta, never dropped. Returns True if a split was applied."""
        from repro_torch.maintenance import executor as maint_exec
        with self._write_lock:
            m = self.modalities[modality]
            if m.workload is None or not m.workload.should_repartition():
                return False
            # a parked partition's pre-merge hits must not win the argmax
            # (its heat is never reset on merge) and suppress the real hot
            # split
            hits = m.workload.hits_snapshot()
            if m.stats is not None:
                hits = np.where(m.stats.parked, -1, hits)
            hot = int(np.argmax(hits))
            res = maint_exec.split_hot(m, self.cfg, self.generator, m.stats,
                                       hot)
            m.workload.reset()
            self._bump_version()
            return bool(res.get("moved", 0))

    def maintain(self, modality: Optional[str] = None,
                 budget: Optional[int] = None, *, need_rows: int = 0):
        """One adaptive-maintenance pass: plan cost-worthy actions from the
        write-time partition statistics and apply them as bounded-work
        steps.

        budget: row budget for this pass (default ``cfg.maint_budget_rows``)
        — the planner picks the best benefit/row actions that fit.
        need_rows: caller must free at least this many delta slots (the
        insert path's never-drop-a-write hook); forces drain chunks ahead
        of the budget.

        Returns the ``MaintenanceReport`` for ``modality`` (or a dict of
        reports over all modalities when ``modality`` is None). The applied
        decision trail is also surfaced in ``metrics()['maintenance']``.

        Obs: the pass's wall time lands in the ``index.maintain`` histogram
        (write-path stall, since maintenance runs inline with mutations);
        each applied action bumps ``maintenance.actions.<kind>`` and its
        moved/drained/reclaimed rows accumulate in
        ``maintenance.rows_moved``."""
        with obs.span("index.maintain"), self._write_lock:
            return self._maintain_locked(modality, budget,
                                         need_rows=need_rows)

    def _maintain_locked(self, modality: Optional[str] = None,
                         budget: Optional[int] = None, *,
                         need_rows: int = 0):
        from repro_torch.maintenance import executor as maint_exec
        cfg = self.cfg
        budget = cfg.maint_budget_rows if budget is None else int(budget)
        if budget <= 0 and need_rows <= 0:
            # an explicit zero budget is "no optional work", not "default"
            return ({m: MaintenanceReport(m) for m in self.modalities}
                    if modality is None else MaintenanceReport(modality))
        reports: Dict[str, MaintenanceReport] = {}
        for mod in ([modality] if modality else list(self.modalities)):
            m = self.modalities[mod]
            if m.stats is None:
                m.stats = PartitionStats.from_build(
                    m.vectors, m.ids, m.ivf,
                    max_ids=int(m.delta.tombstones.shape[0]))
            heat = None if m.workload is None else m.workload.hits_snapshot()
            actions = plan_maintenance(
                m.stats.summarize(m, heat),
                budget_rows=budget,
                chunk=cfg.maint_chunk, need_rows=need_rows,
                delta_pressure=cfg.maint_delta_pressure,
                heat_imbalance=cfg.maint_heat_imbalance,
                split_min_fill=cfg.maint_split_min_fill,
                merge_max_fill=cfg.maint_merge_max_fill,
                drift_threshold=cfg.maint_drift_threshold)
            report = MaintenanceReport(mod)
            cleared = 0
            skip_chunks = False
            for act in actions:
                if act.kind == "compact_chunk" and skip_chunks:
                    continue
                res = maint_exec.apply(m, cfg, self.generator, m.stats, act)
                report.actions.append((act, res))
                obs.counter(f"maintenance.actions.{act.kind}").inc()
                obs.counter("maintenance.rows_moved").inc(
                    res.get("drained", 0) + res.get("moved", 0)
                    + res.get("reclaimed", 0))
                cleared += res.get("cleared_superseded", 0)
                if act.kind == "compact_chunk" and not (
                        res.get("drained", 0) or res.get("reclaimed", 0)):
                    # every target partition is full (or the delta emptied):
                    # further chunks this pass would spin without progress
                    skip_chunks = True
                if (act.kind == "split_hot" and res.get("ivf_changed", False)
                        and m.workload is not None):
                    m.workload.reset()
            if cleared and m.nsw is not None:
                # drained updates cleared superseded bits — exactly like a
                # full compaction, the NSW layer must refresh over the
                # latest master rows or it would serve pre-update scores
                m.nsw = self._build_nsw(m.vectors)
            reports[mod] = report
        trail = "; ".join(r.describe() for r in reports.values()
                          if not r.is_noop)
        if trail:
            # the latest *applied* decision trail (a no-op pass leaves the
            # last real decision visible — that is the interesting one)
            self._metrics["maintenance"] = trail
            # only an *applied* pass can change results: a no-op plan must
            # not invalidate serving caches (MaintenanceDriver ticks constantly)
            self._bump_version()
        return reports[modality] if modality else reports

    # ------------------------------------------------------- durability state
    # The complete state as a flat {key: tensor} dict + JSON-able metadata,
    # in the reference's key layout (``repro.core.index.HMGIIndex
    # .state_tree``), so ``convert.index_from_jax_state`` reads a reference
    # snapshot through the same ``restore_state``. "key" holds this index's
    # torch.Generator state. The tensors are the index's own (an update
    # rewrites master rows in place): copy them, under the write lock, to
    # keep a snapshot (``persistence.snapshot.write_snapshot`` does).

    def state_tree(self) -> Tuple[Dict[str, object], Dict[str, object]]:
        with self._write_lock:
            tree: Dict[str, object] = {"key": self.generator.get_state()}
            meta: Dict[str, object] = {
                "n_nodes": int(self.n_nodes),
                "modalities": {},
                "graph": self.graph is not None,
                "communities": self.communities is not None,
                "boosted_weights": self.boosted_weights is not None,
                "attr_columns": None,
                "sparse_docs": self.sparse_docs is not None,
            }
            for mod, m in self.modalities.items():
                p = f"m/{mod}"
                for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
                    tree[f"{p}/ivf/{f}"] = getattr(m.ivf, f)
                for f in delta_mod.DeltaStore._fields:
                    tree[f"{p}/delta/{f}"] = getattr(m.delta, f)
                tree[f"{p}/vectors"] = m.vectors
                tree[f"{p}/ids"] = m.ids
                if m.nsw is not None:
                    for f in nsw_mod.NSWGraph._fields:
                        tree[f"{p}/nsw/{f}"] = getattr(m.nsw, f)
                if m.workload is not None:
                    tree[f"{p}/workload_hits"] = m.workload.hits_snapshot()
                if m.stats is not None:
                    for f in _STATS_FIELDS:
                        tree[f"{p}/stats/{f}"] = getattr(m.stats, f).copy()
                meta["modalities"][mod] = {
                    "bits": int(m.ivf.bits),
                    "has_dead": bool(m.has_dead),
                    "nsw": m.nsw is not None,
                    "workload": m.workload is not None,
                    "stats": m.stats is not None,
                    "stats_max_ids": (int(m.stats.max_ids)
                                      if m.stats is not None else 0),
                }
            if self.graph is not None:
                for f in GraphStore._fields:
                    tree[f"graph/{f}"] = getattr(self.graph, f)
            if self.communities is not None:
                tree["communities"] = np.asarray(self.communities)
            if self.boosted_weights is not None:
                tree["boosted_weights"] = self.boosted_weights
            if self.attributes is not None:
                tree["attributes/values"] = self.attributes.values
                meta["attr_columns"] = sorted(self.attributes.columns,
                                              key=self.attributes.columns.get)
            if self.sparse_docs is not None:
                tree["sparse/term_ids"] = self.sparse_docs.term_ids
                tree["sparse/term_weights"] = self.sparse_docs.term_weights
            return tree, meta

    def restore_state(self, tree: Dict[str, object],
                      meta: Dict[str, object]) -> None:
        """Rebuilds this (freshly constructed) index from ``state_tree``
        output — tensors or numpy arrays, on any device — onto this index's
        device. "key" is the generator state: a uint8 tensor or numpy array
        (a port snapshot, in memory or read from disk) is loaded as is, so
        later random draws continue the snapshotted stream; a uint32 array
        (a reference JAX PRNG key, ``convert.index_from_jax_state``)
        reseeds the generator from ``seed``; anything else raises
        ``ValueError``. The partition statistics (``stats/*``, host numpy)
        keep their stored dtypes."""
        with self._write_lock:
            self._restore_state_locked(tree, meta)

    def _restore_generator(self, key) -> None:
        if isinstance(key, np.ndarray):
            key = torch.from_numpy(key.copy())
        if not isinstance(key, torch.Tensor) or key.dim() != 1:
            raise ValueError(f"restore_state: 'key' must be a generator state "
                             f"(uint8) or a JAX PRNG key (uint32), got "
                             f"{type(key).__name__}")
        if key.dtype == torch.uint8:
            self.generator.set_state(key.cpu().contiguous())
        elif key.dtype == torch.uint32:
            self.generator.manual_seed(self.seed)
        else:
            raise ValueError(f"restore_state: 'key' must be uint8 (a generator "
                             f"state) or uint32 (a JAX PRNG key), got "
                             f"{key.dtype}")

    def _restore_state_locked(self, tree, meta) -> None:
        def t(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device, copy=True)
            return torch.tensor(x, device=self.device)      # one copy

        self.n_nodes = int(meta["n_nodes"])
        self._restore_generator(tree.get("key"))
        self.modalities = {}
        for mod, mm in meta["modalities"].items():
            p = f"m/{mod}"
            ivf = ivf_mod.IVFIndex(
                **{f: t(tree[f"{p}/ivf/{f}"])
                   for f in ("centroids", "data", "vmin", "scale", "ids",
                             "counts")},
                bits=int(mm["bits"]))
            dstore = delta_mod.DeltaStore(
                **{f: t(tree[f"{p}/delta/{f}"])
                   for f in delta_mod.DeltaStore._fields})
            m = ModalityIndex(ivf=ivf, delta=dstore,
                              vectors=t(tree[f"{p}/vectors"]),
                              ids=t(tree[f"{p}/ids"]),
                              has_dead=bool(mm["has_dead"]))
            if mm["nsw"]:
                m.nsw = nsw_mod.NSWGraph(
                    **{f: t(tree[f"{p}/nsw/{f}"])
                       for f in nsw_mod.NSWGraph._fields})
            if mm["workload"]:
                m.workload = WorkloadStats(ivf.n_partitions)
                m.workload.load_hits(np.asarray(tree[f"{p}/workload_hits"]))
            if mm["stats"]:
                st = PartitionStats(ivf.n_partitions, int(mm["stats_max_ids"]))
                for f in _STATS_FIELDS:
                    setattr(st, f, np.array(tree[f"{p}/stats/{f}"], copy=True))
                m.stats = st
            self.modalities[mod] = m
        self.graph = (GraphStore(**{f: t(tree[f"graph/{f}"])
                                    for f in GraphStore._fields})
                      if meta["graph"] else None)
        self.communities = (np.array(tree["communities"], copy=True)
                            if meta["communities"] else None)
        self.boosted_weights = (t(tree["boosted_weights"])
                                if meta["boosted_weights"] else None)
        if meta["attr_columns"] is not None:
            self.attributes = NodeAttributes(
                {n: i for i, n in enumerate(meta["attr_columns"])},
                t(tree["attributes/values"]))
        else:
            self.attributes = None
        self.sparse_docs = (rerank_mod.SparseVectors(
            term_ids=t(tree["sparse/term_ids"]),
            term_weights=t(tree["sparse/term_weights"]))
            if meta["sparse_docs"] else None)
        self._bump_version()

    # ------------------------------------------------------------------ stats
    def metrics(self) -> Dict[str, object]:
        """Execution-side observability: the filter selectivity/mode of the
        last filtered seed scan, the stage times of the last ingest, the
        latest applied maintenance decision trail under ``"maintenance"``
        (one line per modality acted on), and the process-global obs
        registry snapshot under ``"obs"`` (counters, gauges, histogram
        summaries with exact p50/p90/p99 — see ``repro_torch.obs``)."""
        out = dict(self._metrics)
        out["obs"] = obs.snapshot()
        return out

    def memory_usage(self) -> Dict[str, int]:
        """Bytes per component: one entry per modality's stable slab, one
        per delta store (fp32 master + int8 mirror + dequant terms), the
        graph, and a "total" sum."""
        out = {}
        for mod, m in self.modalities.items():
            out[mod] = m.ivf.nbytes
            out[f"{mod}_delta"] = int(m.delta.vectors.numel() * 4
                                      + m.delta.qdata.numel()
                                      + (m.delta.qvmin.numel()
                                         + m.delta.qscale.numel()) * 4)
        if self.graph is not None:
            out["graph"] = self.graph.nbytes
        out["total"] = sum(out.values())
        return out
