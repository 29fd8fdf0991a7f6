"""Staged executor for compiled query plans.

Each physical stage maps onto the core primitives — the IVF probe
(``ivf.search`` via ``delta.search_with_delta``, or ``ivf.search_sharded``
via ``delta.search_with_delta_sharded`` where the planner chose the
row-sharded layout), typed masked traversal
(``traversal.multi_hop_batch``), candidate-sparse fusion
(``index._fuse_candidates``) — and threads one fixed-shape (Q, C)
candidate-set state ``(scores, ids)`` between stages: scores descending,
−inf on empty slots, ids −1 there.

This module is also the one execution path behind the facade:
``HMGIIndex.search`` and ``hybrid_search`` compile the equivalent plan and
run it here. ``search_bucketed`` is the serving micro-batch entry.

Spans (``repro_torch.obs``) carry the reference's names and nesting:
``query.execute`` around a plan, with ``query.seed_scan`` /
``query.setop``, ``query.traversal``, ``query.fusion`` and
``query.cross_modal`` inside it; each fences its outputs, so with
``cfg.obs_sync_spans`` a span waits for the device work it launched.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.reduce import row_dot
from repro_torch.common.topk import top_k
from repro_torch.core import delta as delta_mod
from repro_torch.core import graph_store as graph_mod
from repro_torch import obs
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import nsw as nsw_mod
from repro_torch.core import traversal as trav_mod
from repro_torch.core.fusion import (FusionWeights, adaptive_weights,
                                     fuse_topk_sparse, scatter_sim)
from repro_torch.core.index import _fuse_candidates
from repro_torch.core.partitioner import assign_topk
from repro_torch.common.shapes import pow2_round
from repro_torch.kernels.ivf_topk.ref import pad_topk
from repro_torch.query.planner import (PhysicalPlan, PSeed, PSetOp,
                                       PTraverse, PRescore)

State = Tuple[torch.Tensor, torch.Tensor]   # (scores (Q, C), ids (Q, C))

_NEG_INF = float("-inf")


def _topk_state(sv: torch.Tensor, si: torch.Tensor, k: int) -> State:
    """Top-k scores descending, ids gathered along, −1 wherever the score is
    −inf (empty slots must never leak a masked id)."""
    vals, pos = top_k(sv, k)
    ids = torch.gather(si, 1, pos)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


# ------------------------------------------------------------------ seed scan
def search_raw(index, m, q: torch.Tensor, probes, n_probe: int, k: int,
               node_pass=None, impl: str = "auto", sharded=None) -> State:
    """One stable+delta scan round (centroids pre-scored in ``probes``),
    with the optional NSW refine lane (MVCC-visibility- and
    predicate-masked). ``sharded`` (the placed ivf.shard_index replica)
    routes the stable scan through the row-sharded path — same masks, same
    probes, same merged results, the work spread over the mesh's db
    shards."""
    if sharded is not None:
        scores, ids = delta_mod.search_with_delta_sharded(
            sharded, m.delta, q, index.mesh, n_probe=n_probe, k=k,
            rescore_margin=index.cfg.delta_rescore_margin, probes=probes,
            node_pass=node_pass, impl=impl, mvcc_filter=m.has_dead)
    else:
        scores, ids = delta_mod.search_with_delta(
            m.ivf, m.delta, q, n_probe=n_probe, k=k,
            rescore_margin=index.cfg.delta_rescore_margin, probes=probes,
            node_pass=node_pass, impl=impl, mvcc_filter=m.has_dead)
    if index.cfg.use_nsw_refine and m.nsw is not None:
        ns, ni = nsw_mod.search(m.nsw, q, ef=index.cfg.nsw_ef, k=k)
        n_rows = m.ids.shape[0]
        ni = torch.where(ni >= 0, m.ids[ni.clamp(0, n_rows - 1).long()], -1)
        # the NSW layer indexes ingest-time rows: apply the same MVCC
        # visibility rules as the stable scan (deletes and superseded
        # versions must not resurface through the refine lane) plus the
        # predicate mask
        dead = m.delta.tombstones | m.delta.superseded
        ok = (ni >= 0) & ~dead[ni.clamp(0, dead.shape[0] - 1).long()]
        if node_pass is not None:
            ok = ok & graph_mod.mask_pass(node_pass, ni)
        ns = torch.where(ok, ns, _NEG_INF)
        ni = torch.where(ok, ni, -1)
        scores, ids = ivf_mod.dedup_merge_topk(scores, ids, ns, ni, k)
        ids = torch.where(torch.isfinite(scores), ids, -1)
    return scores, ids


def run_seed(index, s: PSeed, node_pass) -> State:
    """ANNS seed stage. Unfiltered, or per the compiled filter plan:
    *pushdown* folds the predicate into the scan validity masks pre-top-k;
    *oversample* scans unfiltered at k_scan and widens (doubling) until
    every query has k qualifying survivors — exact at full probe either
    way."""
    m = index.modalities[s.modality]
    q = s.query
    n_probe = min(s.n_probe, m.ivf.n_partitions)
    k = s.k
    # the planner's device-layout choice: resolve the row-sharded replica
    # once per seed stage (built lazily, cached until the stable changes)
    sharded = (index._ensure_sharded(s.modality, s.layout.n_shards)
               if s.layout.layout == "sharded" else None)
    # centroids are scored once per batch: the same assignment feeds the
    # workload tracker and (as precomputed probes) every shard's IVF scan
    probes, _ = assign_topk(q, m.ivf.centroids, n_probe)
    if m.workload is not None:
        m.workload.record(probes.cpu().numpy())
    if node_pass is None:
        return search_raw(index, m, q, probes, n_probe, k, impl=s.impl,
                          sharded=sharded)
    index._metrics["filter_selectivity"] = s.filter_plan.selectivity
    index._metrics["filter_mode"] = s.filter_plan.mode
    if s.filter_plan.mode == "prefilter":
        return search_raw(index, m, q, probes, n_probe, k,
                          node_pass=node_pass, impl=s.impl, sharded=sharded)
    k_max = min(int(m.ids.shape[0]),
                n_probe * m.ivf.capacity + m.delta.ids.shape[0])
    k_scan = min(max(k, pow2_round(s.filter_plan.k_scan)), k_max)
    while True:
        sv, si = search_raw(index, m, q, probes, n_probe, k_scan, impl=s.impl,
                            sharded=sharded)
        ok = graph_mod.mask_pass(node_pass, si)
        sv = torch.where(ok, sv, _NEG_INF)
        if k_scan >= k_max:
            break
        if int(ok.sum(dim=1).min()) >= k:
            break
        k_scan = min(2 * k_scan, k_max)
    vals, ids = _topk_state(sv, si, min(k, sv.shape[1]))
    return pad_topk(vals, ids, k)


# ------------------------------------------------------------- traverse+fuse
def run_traverse(index, t: PTraverse, sv: torch.Tensor, si: torch.Tensor,
                 node_pass) -> State:
    """h-hop traversal seeded by the current candidate set, fused back into
    the scores (Eq. 3) via the compiled representation. hops=0 passes the
    set through."""
    if t.n_hops == 0:
        return sv, si
    cfg = index.cfg
    g = index.graph
    if index.boosted_weights is not None:
        g = g._replace(edge_weight=index.boosted_weights)
    with obs.span("query.traversal") as sp:
        graph_scores = sp.fence(trav_mod.multi_hop_batch(
            g, si, sv, n_hops=t.n_hops, edge_type_mask=t.edge_type_mask,
            node_mask=node_pass, damping=t.damping))                # (Q, N)
    with obs.span("query.fusion") as sp:
        qn = sv.shape[0]
        w = (adaptive_weights(sv, base_wv=cfg.w_vector, base_wg=cfg.w_graph)
             if cfg.adaptive_weights else
             FusionWeights(torch.full((qn,), cfg.w_vector, device=sv.device),
                           torch.full((qn,), cfg.w_graph, device=sv.device)))
        if t.repr == "sparse":
            out = _fuse_candidates(sv, si, graph_scores, w.w_vector,
                                   w.w_graph, k_fuse=t.k_fuse,
                                   frontier=t.frontier, node_pass=node_pass)
        else:
            out = _fuse_dense(sv, si, graph_scores, w.w_vector, w.w_graph,
                              k_fuse=t.k_fuse, node_pass=node_pass)
        return sp.fence(out)


def _fuse_dense(sv, si, graph_scores, wv, wg, *, k_fuse: int, node_pass=None):
    """Dense fusion representation: one scatter of the candidate sims over
    all N nodes (positions are ids), then Eq. 3 + top-k_fuse."""
    sim_full = scatter_sim(graph_scores.shape[1], si, sv)
    valid = (None if node_pass is None else
             node_pass[None, :].expand(graph_scores.shape))
    vals, pos = fuse_topk_sparse(sim_full, graph_scores,
                                 FusionWeights(wv, wg), k_fuse, valid=valid)
    return vals, torch.where(torch.isfinite(vals), pos, -1)


# --------------------------------------------------------------- cross-modal
def run_rescore(index, r: PRescore, sv: torch.Tensor, si: torch.Tensor) -> State:
    m = index.modalities[r.modality]
    rows = index._modality_id_rows(r.modality)
    return _rescore(r.query, m.vectors, rows, m.delta.tombstones, sv, si,
                    r.weight)


def _modality_rows(ids: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(n_nodes,) global-id -> row map for one modality (-1 = no embedding)."""
    rows = torch.full((n_nodes,), -1, dtype=torch.int32, device=ids.device)
    rows[ids.clamp(0, n_nodes - 1).long()] = torch.arange(
        ids.shape[0], dtype=torch.int32, device=ids.device)
    return rows


def _rescore(q2, vectors, rows, tombstones, sv, si, weight: float):
    """new = (1-w)·current + w·sim2 over the fp32 master rows of the second
    modality; candidates without a live embedding there read sim2 = 0.
    Width-preserving, re-sorted descending."""
    rr = rows[si.clamp(0, rows.shape[0] - 1).long()]
    present = (si >= 0) & (rr >= 0)
    present = present & ~tombstones[si.clamp(0, tombstones.shape[0] - 1).long()]
    vecs = vectors[rr.clamp(0, vectors.shape[0] - 1).long()]      # (Q, C, d2)
    sim2 = row_dot(q2[:, None, :], vecs)
    sim2 = torch.where(present, sim2, 0.0)
    new = torch.where(torch.isfinite(sv), (1.0 - weight) * sv + weight * sim2,
                      _NEG_INF)
    return _topk_state(new, si, new.shape[1])


# ------------------------------------------------------------------- set ops
def run_setop(index, op: PSetOp) -> State:
    la, li = execute(index, op.left)
    ra, ri = execute(index, op.right)
    return (_union if op.kind == "union" else _intersect)(la, li, ra, ri)


def _union(sa, ia, sb, ib):
    """ids from either side; duplicate ids keep their higher score."""
    vals, ids = ivf_mod.dedup_merge_topk(sa, ia, sb, ib,
                                         sa.shape[1] + sb.shape[1])
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def _intersect(sa, ia, sb, ib):
    """ids live on both sides; score = mean of the two sides' scores."""
    match = (ia[:, :, None] == ib[:, None, :]) & (ia[:, :, None] >= 0)
    match = match & torch.isfinite(sb)[:, None, :]
    sb_at = torch.where(match, sb[:, None, :], _NEG_INF).amax(dim=-1)
    both = torch.isfinite(sa) & torch.isfinite(sb_at)
    s = torch.where(both, 0.5 * (sa + sb_at), _NEG_INF)
    return _topk_state(s, ia, s.shape[1])


def _post_filter(sv, si, node_pass):
    """Outer Where over a set-op source: the merged set is post-filtered
    (and later stages still carry the mask)."""
    ok = graph_mod.mask_pass(node_pass, si)
    return _topk_state(torch.where(ok, sv, _NEG_INF), si, sv.shape[1])


# ------------------------------------------------------- serving micro-batch
def search_bucketed(index, queries, modality: str, *, k: int,
                    n_probe: Optional[int] = None, where=None,
                    n_hops: int = 0, impl: str = "auto",
                    floor: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """The cross-request retrieval entry: one ``(B, k)`` call over the pow2
    bucket ``B = pow2_round(Q, lo=floor)``, rows sliced back to Q, returned
    as numpy (scores (Q, k), ids (Q, k)).

    Padding repeats row 0. Every per-row stage (probe assignment, scan,
    top-k, traversal, fusion, rescore) is row-separable, so a pad row's
    content cannot change a real row's result. Whether the bytes of a row
    are independent of the bucket it rode in depends on the device's
    reduction order (cuBLAS rescore, cuSPARSE hops): the port does not
    promise it on the card (ROADMAP Queue 1 item 14)."""
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None]
    n_q = q.shape[0]
    bucket = pow2_round(n_q, lo=max(int(floor), 1))
    if bucket != n_q:
        q = np.concatenate(
            [q, np.broadcast_to(q[:1], (bucket - n_q,) + q.shape[1:])])
    if n_hops > 0:
        sv, si = index.hybrid_search(q, modality, k=k, n_hops=n_hops,
                                     n_probe=n_probe, where=where)
    else:
        sv, si = index.search(q, modality, k=k, n_probe=n_probe,
                              where=where, impl=impl)
    return sv[:n_q].cpu().numpy(), si[:n_q].cpu().numpy()


# ----------------------------------------------------------------- execution
def run_topk(sv: torch.Tensor, si: torch.Tensor, k: int) -> State:
    """Terminal truncation to k (padded with (−inf, −1) past the width)."""
    vals, ids = _topk_state(sv, si, min(k, sv.shape[1]))
    return pad_topk(vals, ids, k)


def execute(index, phys: PhysicalPlan, *, truncate: bool = True) -> State:
    """Runs a compiled plan. truncate=False returns the last stage's full
    candidate set (the facade's rerank lane re-scores it before cutting)."""
    with obs.span("query.execute") as root:
        if isinstance(phys.source, PSetOp):
            with obs.span("query.setop") as sp:
                sv, si = sp.fence(run_setop(index, phys.source))
                if phys.node_pass is not None:
                    sv, si = sp.fence(_post_filter(sv, si, phys.node_pass))
        else:
            with obs.span("query.seed_scan") as sp:
                sv, si = sp.fence(
                    run_seed(index, phys.source, phys.node_pass))
        for st in phys.stages:
            if isinstance(st, PTraverse):
                sv, si = run_traverse(index, st, sv, si, phys.node_pass)
            else:
                with obs.span("query.cross_modal") as sp:
                    sv, si = sp.fence(run_rescore(index, st, sv, si))
        if truncate:
            sv, si = run_topk(sv, si, phys.k)
        return root.fence((sv, si))
