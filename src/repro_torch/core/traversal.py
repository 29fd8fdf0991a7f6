"""Graph traversal as masked frontier expansion (the Cypher-traversal analogue).

An h-hop traversal from a weighted seed set is h pushes of mass along the
edges: ``s_gi`` in Eq. 3 is the (normalised) seed mass reaching node i at
hop g. Edge-type filters and per-hop damping are masks.

The batch runs as one sparse product per hop: a sparse adjacency (dst × src,
values = normalised edge weight) times an (N, Q) frontier, so no (Q, E)
message tensor ever exists. The reference sums per query with
``segment_sum``; the order of the sum differs, so results agree to fp32
rounding (about 1e-6 relative), not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.params import resolve_device
from repro_torch.core.graph_store import GraphStore, edge_type_lut
from repro_torch.kernels.segment_reduce.ops import segment_sum_csr


class TraversalResult(NamedTuple):
    per_hop: torch.Tensor   # (h, N) fp32 — mass arriving at each node per hop
    total: torch.Tensor     # (N,) fp32 — mean over hops (Eq. 3's (1/h)·Σ s_g)


def as_edge_mask(edge_type_mask, device=None) -> Optional[torch.Tensor]:
    """Normalises the two spellings of an edge-type filter: a (T,) mask
    tensor (indexed by edge type) passes through; an iterable of edge-type
    ids compiles to one via ``graph_store.edge_type_lut`` on ``device``
    (None = the CUDA device). Edge types ≥ T read as excluded."""
    device = resolve_device(device, "traversal.as_edge_mask")
    if edge_type_mask is None or isinstance(edge_type_mask, torch.Tensor):
        return edge_type_mask
    return edge_type_lut(edge_type_mask, device=device)


def _edge_weights(g: GraphStore, edge_type_mask) -> torch.Tensor:
    ew = g.edge_weight
    edge_type_mask = as_edge_mask(edge_type_mask, ew.device)
    if edge_type_mask is not None:
        # safe gather: types beyond the mask's domain are excluded
        t = edge_type_mask.shape[0]
        m = edge_type_mask.to(ew.device)[g.edge_type.clamp(0, t - 1).long()]
        ew = ew * torch.where(g.edge_type < t, m, 0.0)
    return ew


def _push_operator(g: GraphStore, ew: torch.Tensor) -> torch.Tensor:
    """(N, N) sparse (coalesced COO) A with A[dst, src] =
    ew / out_degree_w(src): one hop is ``A @ frontier`` (random-walk style
    push)."""
    n = g.n_nodes
    # out-weights summed per source in edge order: the edges are stored by
    # source (``indptr`` is their CSR), so one fixed-order segment sum (the
    # kernel on the card) gives the bits of index_add_ on the CPU, where
    # index_add_'s atomics on the card would not fix them
    deg_w = segment_sum_csr(ew[:, None].contiguous(), g.indptr)[:, 0]
    src = g.src.long()
    inv_deg = torch.where(deg_w > 0, 1.0 / torch.clamp_min(deg_w, 1e-12), 0.0)
    vals = inv_deg[src] * ew
    return torch.sparse_coo_tensor(torch.stack([g.indices.long(), src]), vals,
                                   (n, n), check_invariants=False).coalesce()


def _expand(a: torch.Tensor, seed: torch.Tensor, n_hops: int,
            nm: Optional[torch.Tensor], damping: float, top_m: int
            ) -> torch.Tensor:
    """seed: (N, B) frontier columns. Returns (n_hops, N, B) per-hop mass."""
    n = seed.shape[0]
    frontier = seed if nm is None else seed * nm[:, None]
    out = []
    for _ in range(n_hops):
        nxt = torch.sparse.mm(a, frontier) * damping
        if nm is not None:
            nxt = nxt * nm[:, None]
        if top_m:
            # only the m-th value is used, so the order among ties
            # (which torch.topk leaves open) does not matter here
            kth = torch.topk(nxt, min(top_m, n), dim=0).values[-1]
            nxt = torch.where(nxt >= kth[None, :], nxt, 0.0)
        out.append(nxt)
        frontier = nxt
    return torch.stack(out)


def frontier_expand(g: GraphStore, seed_scores: torch.Tensor, *, n_hops: int,
                    edge_type_mask: Optional[torch.Tensor] = None,
                    node_mask: Optional[torch.Tensor] = None,
                    damping: float = 0.85,
                    top_m: int = 0) -> TraversalResult:
    """seed_scores: (N,) fp32 (zeros except seeds). Returns per-hop node mass.

    node_mask: optional (N,) bool — excluded nodes neither receive nor
    forward mass. top_m > 0 prunes each hop's frontier to its m strongest
    nodes."""
    a = _push_operator(g, _edge_weights(g, edge_type_mask))
    nm = None if node_mask is None else node_mask.to(torch.float32)
    per_hop = _expand(a, seed_scores.to(torch.float32)[:, None], n_hops, nm,
                      damping, top_m)[:, :, 0]
    return TraversalResult(per_hop=per_hop, total=per_hop.mean(dim=0))


def seeds_from_topk(n_nodes: int, ids: torch.Tensor, scores: torch.Tensor
                    ) -> torch.Tensor:
    """Scatter (Q, k) vector-search results into (N, Q) seed-mass columns.

    Scores are shifted to be non-negative and normalised per query so
    traversal mass is comparable across queries (invalid ids < 0 are
    dropped). A (k,) input gives an (N,) vector."""
    if ids.dim() == 1:
        return seeds_from_topk(n_nodes, ids[None], scores[None])[:, 0]
    valid = ids >= 0
    smin = torch.where(valid, scores, float("inf")).amin(dim=1, keepdim=True)
    shift = torch.where(torch.isfinite(smin), smin, 0.0)
    w = torch.where(valid, scores - shift + 1e-6, 0.0)
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    qn = ids.shape[0]
    seed = torch.zeros((n_nodes, qn), dtype=torch.float32, device=ids.device)
    cols = torch.arange(qn, device=ids.device)[:, None].expand_as(ids)
    seed.index_put_((ids.clamp(0, n_nodes - 1).long(), cols),
                    torch.where(valid, w, 0.0).to(torch.float32),
                    accumulate=True)
    return seed


def multi_hop_batch(g: GraphStore, ids: torch.Tensor, scores: torch.Tensor, *,
                    n_hops: int, edge_type_mask=None, node_mask=None,
                    damping: float = 0.85, top_m: int = 0) -> torch.Tensor:
    """Traversal for a batch of vector-search results.

    ids/scores: (Q, k) -> (Q, N) graph relevance (mean per-hop mass).
    node_mask: (N,) bool predicate mask shared across the batch.
    edge_type_mask: a (T,) mask or an iterable of edge-type ids."""
    a = _push_operator(g, _edge_weights(g, edge_type_mask))
    nm = None if node_mask is None else node_mask.to(torch.float32)
    seed = seeds_from_topk(g.n_nodes, ids, scores)                 # (N, Q)
    per_hop = _expand(a, seed, n_hops, nm, damping, top_m)         # (h, N, Q)
    return per_hop.mean(dim=0).T.contiguous()
