"""Navigable-small-world graph index — the paper's HNSW component as a
fixed out-degree adjacency and a fixed-width beam search (``ef``
candidates), batched over queries. It validates the paper's graph-index
semantics (recall vs ef); the production hot path is the IVF scan, and the
facade's NSW refine lane merges its results into the scan's.

Build is IVF-accelerated: each node's M approximate nearest neighbours come
from an IVF search over the corpus (classic NN-descent seeding) — a
throwaway 16-partition, 16-bit index probed at 4. The port computes that
search grouped by partition (``_knn_grouped``): the rows that probe a
partition times its dequantized block in one fp32 ``torch.matmul``, a
top-k per partition, then one merge per row in the reference's order.
That is the same function as ``ivf.search(impl="einsum")`` without its
per-query gather of every probed block.

Search keeps the reference's semantics (a ``vmap`` of a ``while_loop``):
every query steps until its beam has no unexpanded entry or ``max_steps``
is reached; the batch runs ``max_steps`` steps, and a query that has
finished keeps its state (``torch.where`` on its ``active`` bit), with no
host sync inside the loop. One difference by design: a step marks only
its real neighbours visited. The reference's scatter also writes row 0's
old bit back for every padded neighbour, and where that write lands last
(XLA on the CPU applies duplicate updates in order) row 0 is un-marked
and can enter the beam twice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.common.reduce import row_dot, row_sum
from repro_torch.common.topk import top_k
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import partitioner
from repro_torch.kernels.ivf_topk.ref import pad_topk

# the grouped build's score blocks hold at most this many fp32 elements
_BLOCK_ELEMS = 1 << 27


class NSWGraph(NamedTuple):
    vectors: torch.Tensor      # (N, d) fp32
    neighbors: torch.Tensor    # (N, M) int32, -1 padded
    entry: torch.Tensor        # () int32 — fixed entry point (medoid-ish)


def _knn_grouped(index: ivf_mod.IVFIndex, queries: torch.Tensor, *,
                 n_probe: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ivf.search(index, queries, n_probe=n_probe, k=k, impl="einsum")``
    computed partition by partition: (scores (Q, k), ids (Q, k)).

    Each partition's block is dequantized once and multiplied by every
    query that probes it; its top-min(k, cap) per query keeps slot order
    among equal scores, and the per-probe lists, laid side by side in probe
    order, merge under ``top_k``'s position order — the einsum route's
    order over the flat (probe, slot) axis."""
    q = queries.to(torch.float32)
    nq = q.shape[0]
    n_part, cap = index.ids.shape
    n_probe = min(n_probe, n_part)
    probe, _ = partitioner.assign_topk(q, index.centroids, n_probe)  # (Q, P)
    kk = min(k, cap)
    vals = torch.full((nq, n_probe, kk), float("-inf"), device=q.device)
    flat = torch.zeros((nq, n_probe, kk), dtype=torch.int64, device=q.device)
    block = max(1, _BLOCK_ELEMS // cap)
    for p in range(n_part):
        qi, j = torch.nonzero(probe == p, as_tuple=True)
        if not qi.numel():
            continue
        vecs = ivf_mod._dequant_rows(index, index.data[p], index.vmin[p],
                                     index.scale[p])                 # (cap, d)
        valid = index.ids[p] >= 0
        for s in range(0, qi.numel(), block):
            qb, jb = qi[s:s + block], j[s:s + block]
            sc = torch.where(valid, torch.matmul(q[qb], vecs.T),
                             float("-inf"))
            v, slot = top_k(sc, kk)
            vals[qb, jb] = v
            flat[qb, jb] = jb[:, None] * cap + slot
    v, pos = top_k(vals.reshape(nq, -1), min(k, n_probe * kk))
    f = torch.gather(flat.reshape(nq, -1), 1, pos)
    part = torch.gather(probe, 1, f // cap).long()
    ids = index.ids[part, f % cap]
    ids = torch.where(torch.isfinite(v), ids, -1)
    return pad_topk(v, ids, k)


def build(vectors: torch.Tensor, *, degree: int = 16, n_partitions: int = 16,
          bits: int = 16, centroids: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> NSWGraph:
    """Builds the graph over ``vectors`` (N, d). The throwaway IVF index is
    fit by K-means seeded from ``generator`` unless ``centroids`` are given
    (as for ``ivf.build``)."""
    n, d = vectors.shape
    dev = vectors.device
    m = min(degree, n - 1)
    kp = min(n_partitions, n)
    index, _ = ivf_mod.build(vectors, torch.arange(n, dtype=torch.int32,
                                                   device=dev),
                             n_partitions=kp, bits=bits,
                             capacity=max(2 * n // kp + 1, 8),
                             centroids=centroids, generator=generator)
    # each node's approx m+1 nearest (self included) via the IVF index
    _, ids = _knn_grouped(index, vectors, n_probe=min(4, n_partitions),
                          k=m + 1)
    self_id = torch.arange(n, device=dev)[:, None]
    neigh = torch.where(ids == self_id, -1, ids)
    # compact: move -1s to the end by sorting on (is_pad, position)
    order = torch.argsort((neigh < 0).to(torch.int8), dim=1, stable=True)
    neigh = torch.gather(neigh, 1, order)[:, :m]
    entry = torch.argmin(row_sum((vectors - vectors.mean(0)) ** 2))
    # the graph's own copy: the facade rewrites its master rows in place
    return NSWGraph(vectors=vectors.to(torch.float32, copy=True),
                    neighbors=neigh.to(torch.int32),
                    entry=entry.to(torch.int32))


def search(graph: NSWGraph, queries: torch.Tensor, *, ef: int = 32,
           k: int = 10, max_steps: int = 64
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search. Returns (scores (Q,k), ids (Q,k)), dot-product
    similarity, descending, (-inf, -1) padded. Each score sums its row in
    ``row_dot``'s order, so a query's result does not depend on its batch.

    ``visited`` is a (Q, N) byte map: Q·N bytes of device memory."""
    q = queries.to(torch.float32)
    vec, nbr = graph.vectors, graph.neighbors
    n = vec.shape[0]
    nq, dev = q.shape[0], q.device
    ninf = float("-inf")
    entry = graph.entry.to(device=dev, dtype=torch.int64)
    rows = torch.arange(nq, device=dev)

    beam_ids = torch.full((nq, ef), -1, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = entry.to(torch.int32)
    beam_scores = torch.full((nq, ef), ninf, device=dev)
    beam_scores[:, 0] = row_dot(vec[entry][None, :], q)
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, n), dtype=torch.uint8, device=dev)
    visited[:, entry] = 1
    no_exp = torch.zeros((nq, nbr.shape[1]), dtype=torch.bool, device=dev)

    # a query steps while its beam has an unexpanded entry; each step that
    # runs is one of its max_steps, so the batch needs max_steps steps
    for _ in range(max_steps):
        frontier = ~expanded & (beam_scores > ninf)
        active = frontier.any(dim=1)[:, None]
        # pick best unexpanded beam entry (first of equal scores)
        pick = torch.where(expanded, ninf, beam_scores).argmax(dim=1)
        exp_new = expanded.clone()
        exp_new[rows, pick] = True
        node = beam_ids[rows, pick].long()
        neigh = nbr[node.clamp(0, n - 1)]                          # (Q, M)
        neigh = torch.where(node[:, None] >= 0, neigh, -1)
        nc = neigh.clamp(0, n - 1).long()
        fresh = (neigh >= 0) & (torch.gather(visited, 1, nc) == 0)
        neigh = torch.where(fresh, neigh, -1)
        # mark only real neighbours (a max never clears a bit)
        visited.scatter_reduce_(1, nc, (fresh & active).to(torch.uint8),
                                reduce="amax")
        ns = torch.where(fresh, row_dot(vec[nc], q[:, None, :]), ninf)
        all_ids = torch.cat([beam_ids, neigh], dim=1)
        all_scores = torch.cat([beam_scores, ns], dim=1)
        all_exp = torch.cat([exp_new, no_exp], dim=1)
        vals, pos = top_k(all_scores, ef)
        beam_ids = torch.where(active, torch.gather(all_ids, 1, pos), beam_ids)
        beam_scores = torch.where(active, vals, beam_scores)
        expanded = torch.where(active, torch.gather(all_exp, 1, pos), expanded)

    vals, pos = top_k(beam_scores, min(k, ef))
    out_ids = torch.gather(beam_ids, 1, pos)
    return pad_topk(vals, out_ids, k)
