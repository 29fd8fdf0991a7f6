"""Brute-force numpy reference interpreter for the port's compiled query
plans: the torch copy of ``tests/query_ref.py`` (CPU tensors read through
``np.asarray``).

``reference_execute`` walks a ``repro_torch.query.planner.PhysicalPlan`` stage by
stage and evaluates each one exhaustively, with no ANN shortcuts:

- seed scans score *every* live row in the representation the index
  actually stores (dequantized int8 for stable rows, fp32 master rows for
  delta rows — so at full probe the engine must reproduce the oracle
  exactly, stable+delta included);
- traversal is the dense h-hop push over the whole edge list (boosted
  weights, edge-type masks, node masks, damping — the same semantics as
  ``traversal.frontier_expand``), fused densely over all N nodes (Eq. 3);
- cross-modal re-scores, set ops, and filters are per-candidate dict math.

Each stage also returns its full candidate *pool* (per-query id -> score
dict). Exactness checks use the pool (``assert_matches``): the engine's
sorted scores must equal the oracle's, and every returned id must carry its
oracle score — tie-robust (equal scores may legally permute ids)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import ivf as ivf_mod
from repro_torch.core.delta import _latest_version_mask
from repro_torch.query.planner import (PhysicalPlan, PRescore, PSeed, PSetOp,
                                 PTraverse)

Ref = Tuple[np.ndarray, np.ndarray, List[Dict[int, float]]]


def stored_corpus(idx, modality: str):
    """(vectors, ids, live) of every row, in the representation the index
    scans: dequantized int8 for stable rows, fp32 master for delta rows
    (latest version per id, tombstones out)."""
    m = idx.modalities[modality]
    data, vmin, scale, sids = m.ivf.slab_view()
    stable = ivf_mod._dequant_rows(m.ivf, data, vmin, scale)
    sids = np.asarray(sids)
    dead = np.asarray(m.delta.tombstones) | np.asarray(m.delta.superseded)
    s_ok = (sids >= 0) & ~dead[np.clip(sids, 0, dead.shape[0] - 1)]
    d_ids = np.asarray(m.delta.ids)
    d_ok = np.asarray(_latest_version_mask(m.delta)) \
        & ~np.asarray(m.delta.tombstones)[np.clip(d_ids, 0, dead.shape[0] - 1)]
    vecs = np.concatenate([np.asarray(stable), np.asarray(m.delta.vectors)])
    ids = np.concatenate([sids, d_ids])
    ok = np.concatenate([s_ok, d_ok])
    return vecs.astype(np.float64), ids, ok


def _topk_rows(scores: np.ndarray, ids: np.ndarray, k: int) -> Ref:
    """Per-row exact top-k over a (Q, R) score matrix with row ids (R,);
    -inf entries pad out as (-inf, -1). Pools keep every finite entry."""
    order = np.argsort(-scores, axis=1)[:, :k]
    vals = np.take_along_axis(scores, order, axis=1)
    out_ids = np.where(np.isfinite(vals), ids[order], -1)
    pad = k - vals.shape[1]
    if pad > 0:
        vals = np.concatenate(
            [vals, np.full((vals.shape[0], pad), -np.inf)], axis=1)
        out_ids = np.concatenate(
            [out_ids, np.full((out_ids.shape[0], pad), -1, out_ids.dtype)],
            axis=1)
    pools = [{int(i): float(s) for i, s in zip(ids, row) if np.isfinite(s)}
             for row in scores]
    return vals, out_ids.astype(np.int64), pools


def _pools_of(sv: np.ndarray, si: np.ndarray) -> List[Dict[int, float]]:
    return [{int(i): float(s) for s, i in zip(rs, ri) if np.isfinite(s)}
            for rs, ri in zip(sv, si)]


def _seed(idx, ps: PSeed, node_pass: Optional[np.ndarray]) -> Ref:
    vecs, ids, ok = stored_corpus(idx, ps.modality)
    if node_pass is not None:
        ok = ok & node_pass[np.clip(ids, 0, len(node_pass) - 1)]
    q = np.asarray(ps.query, np.float64)
    scores = q @ vecs.T
    scores = np.where(ok[None, :], scores, -np.inf)
    return _topk_rows(scores, ids, ps.k)


def _seed_mass(n: int, ids: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """numpy twin of traversal.seeds_from_topk."""
    valid = (ids >= 0) & np.isfinite(scores)
    if not valid.any():
        return np.zeros(n)
    smin = float(np.min(scores[valid]))
    smin = smin if np.isfinite(smin) else 0.0
    w = np.where(valid, scores - smin + 1e-6, 0.0)
    w = w / max(w.sum(), 1e-12)
    seed = np.zeros(n)
    np.add.at(seed, np.clip(ids, 0, n - 1), np.where(valid, w, 0.0))
    return seed


def _weights(cfg, sv: np.ndarray):
    """numpy twin of fusion.adaptive_weights / the fixed-weight branch."""
    qn = sv.shape[0]
    if not cfg.adaptive_weights:
        return np.full(qn, cfg.w_vector), np.full(qn, cfg.w_graph)
    s1 = sv[:, 1] if sv.shape[1] > 1 else sv[:, 0]
    with np.errstate(invalid="ignore"):
        margin = sv[:, 0] - s1
    margin = np.nan_to_num(margin, nan=0.0, posinf=1.0, neginf=0.0)
    conf = 1.0 / (1.0 + np.exp(-4.0 * (margin - 0.05)))
    wv = cfg.w_vector * (0.5 + conf)
    wg = cfg.w_graph * (1.5 - conf)
    tot = wv + wg
    return wv / tot, wg / tot


def _traverse(idx, pt: PTraverse, sv, si,
              node_pass: Optional[np.ndarray]) -> Ref:
    if pt.n_hops == 0:
        return sv, si, _pools_of(sv, si)
    g = idx.graph
    n = idx.n_nodes
    ew = np.asarray(idx.boosted_weights if idx.boosted_weights is not None
                    else g.edge_weight, np.float64)
    src = np.asarray(g.src)
    dst = np.asarray(g.indices)
    if pt.edge_type_mask is not None:
        # safe gather, mirroring frontier_expand: edge types beyond the
        # LUT's domain are excluded
        lut = np.asarray(pt.edge_type_mask, np.float64)
        et = np.asarray(g.edge_type)
        ew = ew * np.where(et < len(lut),
                           lut[np.clip(et, 0, len(lut) - 1)], 0.0)
    deg = np.zeros(n)
    np.add.at(deg, src, ew)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    nm = None if node_pass is None else node_pass.astype(np.float64)

    qn = sv.shape[0]
    gs = np.zeros((qn, n))
    for qi in range(qn):
        frontier = _seed_mass(n, si[qi], sv[qi])
        if nm is not None:
            frontier = frontier * nm
        acc = np.zeros(n)
        for _ in range(pt.n_hops):
            msg = (frontier * inv)[src] * ew
            nxt = np.zeros(n)
            np.add.at(nxt, dst, msg)
            nxt *= pt.damping
            if nm is not None:
                nxt *= nm
            acc += nxt
            frontier = nxt
        gs[qi] = acc / pt.n_hops

    # dense Eq. 3 fusion over all N nodes (duplicate seed ids keep the max)
    sim = np.full((qn, n), -np.inf)
    for qi in range(qn):
        for i, s in zip(si[qi], sv[qi]):
            if i >= 0 and np.isfinite(s):
                sim[qi, i] = max(sim[qi, i], s)
    wv, wg = _weights(idx.cfg, sv)
    s_v = 1.0 - 0.5 * (1.0 - sim)
    gn = gs / np.maximum(gs.max(axis=1, keepdims=True), 1e-12)
    fused = np.where(np.isfinite(sim),
                     wv[:, None] * s_v + wg[:, None] * gn, wg[:, None] * gn)
    if node_pass is not None:
        fused = np.where(node_pass[None, :], fused, -np.inf)
    return _topk_rows(fused, np.arange(n), pt.k_fuse)


def _rescore(idx, pr: PRescore, sv, si) -> Ref:
    m = idx.modalities[pr.modality]
    rows = np.full(idx.n_nodes, -1, np.int64)
    rows[np.asarray(m.ids)] = np.arange(int(m.ids.shape[0]))
    dead = np.asarray(m.delta.tombstones)
    vecs = np.asarray(m.vectors, np.float64)
    q2 = np.asarray(pr.query, np.float64)
    new = np.full(sv.shape, -np.inf)
    for qi in range(sv.shape[0]):
        for ci in range(sv.shape[1]):
            s, i = sv[qi, ci], si[qi, ci]
            if not np.isfinite(s):
                continue
            # no embedding in this modality — never ingested, or deleted
            # (a tombstoned id must not contribute its dead vector)
            r = rows[i] if 0 <= i < idx.n_nodes \
                and not dead[min(i, len(dead) - 1)] else -1
            sim2 = float(q2[qi] @ vecs[r]) if r >= 0 else 0.0
            new[qi, ci] = (1.0 - pr.weight) * s + pr.weight * sim2
    return _sorted(new, si)


def _sorted(sv, si) -> Ref:
    order = np.argsort(-sv, axis=1)
    vals = np.take_along_axis(sv, order, axis=1)
    ids = np.where(np.isfinite(vals),
                   np.take_along_axis(si, order, axis=1), -1)
    return vals, ids, _pools_of(vals, ids)


def _setop(kind: str, left: Ref, right: Ref) -> Ref:
    la, li, _ = left
    ra, ri, _ = right
    qn = la.shape[0]
    width = la.shape[1] + ra.shape[1] if kind == "union" else la.shape[1]
    sv = np.full((qn, width), -np.inf)
    si = np.full((qn, width), -1, np.int64)
    pools: List[Dict[int, float]] = []
    for qi in range(qn):
        a = {int(i): float(s) for s, i in zip(la[qi], li[qi])
             if np.isfinite(s)}
        b = {int(i): float(s) for s, i in zip(ra[qi], ri[qi])
             if np.isfinite(s)}
        if kind == "union":
            d = dict(b)
            for i, s in a.items():
                d[i] = max(d.get(i, -np.inf), s)
        else:
            d = {i: 0.5 * (s + b[i]) for i, s in a.items() if i in b}
        pools.append(d)
        for ci, (i, s) in enumerate(
                sorted(d.items(), key=lambda kv: -kv[1])[:width]):
            sv[qi, ci], si[qi, ci] = s, i
    return sv, si, pools


def reference_execute(idx, phys: PhysicalPlan, truncate: bool = True) -> Ref:
    node_pass = (None if phys.node_pass is None
                 else np.asarray(phys.node_pass))
    if isinstance(phys.source, PSetOp):
        sv, si, pools = _setop(phys.source.kind,
                               reference_execute(idx, phys.source.left),
                               reference_execute(idx, phys.source.right))
        if node_pass is not None:   # outer Where post-filters the merged set
            keep = (si >= 0) & node_pass[np.clip(si, 0, len(node_pass) - 1)]
            sv, si, pools = _sorted(np.where(keep, sv, -np.inf), si)
    else:
        sv, si, pools = _seed(idx, phys.source, node_pass)
    for st in phys.stages:
        if isinstance(st, PTraverse):
            sv, si, pools = _traverse(idx, st, sv, si, node_pass)
        else:
            sv, si, pools = _rescore(idx, st, sv, si)
    if truncate:
        sv, si = _truncate(sv, si, phys.k)
    return sv, si, pools


def _truncate(sv, si, k) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(-sv, axis=1)[:, :k]
    vals = np.take_along_axis(sv, order, axis=1)
    ids = np.where(np.isfinite(vals),
                   np.take_along_axis(si, order, axis=1), -1)
    pad = k - vals.shape[1]
    if pad > 0:
        vals = np.concatenate(
            [vals, np.full((vals.shape[0], pad), -np.inf)], axis=1)
        ids = np.concatenate(
            [ids, np.full((ids.shape[0], pad), -1, ids.dtype)], axis=1)
    return vals, ids


def assert_matches(engine_out, ref: Ref, atol: float = 2e-5):
    """Tie-robust exactness: sorted scores equal, finiteness patterns equal,
    and every engine id carries exactly its oracle score (ids with equal
    scores may permute)."""
    sv, si = np.asarray(engine_out[0]), np.asarray(engine_out[1])
    rv, ri, pools = ref
    assert sv.shape == rv.shape, (sv.shape, rv.shape)
    fe, fr = np.isfinite(sv), np.isfinite(rv)
    np.testing.assert_array_equal(fe, fr)
    np.testing.assert_allclose(np.where(fe, sv, 0.0), np.where(fr, rv, 0.0),
                               rtol=2e-5, atol=atol)
    for qi in range(sv.shape[0]):
        for s, i in zip(sv[qi], si[qi]):
            if np.isfinite(s):
                assert int(i) in pools[qi], (qi, int(i))
                ref_s = pools[qi][int(i)]
                assert abs(ref_s - s) <= atol + 2e-5 * abs(ref_s), \
                    (qi, int(i), ref_s, float(s))
