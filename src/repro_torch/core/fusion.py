"""Hybrid score fusion (paper Eq. 3) with DEG-inspired adaptive weights.

    S = w_v · (1 − d_v) + w_g · (1/h) · Σ_g s_g

``d_v`` is the normalised vector distance (cosine distance for unit-norm
embeddings), the graph term the mean per-hop traversal mass from
``core/traversal.py``. Adaptive weighting shifts weight toward the vector
side when the ANN margin is confident and toward the graph side when it is
ambiguous.

Candidate-sparse formulation: fusion only ever needs the union of the ANNS
seeds and the traversal frontier's strongest nodes, so ``fuse_topk_sparse``
operates on an explicit (Q, C) candidate set with the graph normaliser
passed in. The dense ``fuse_topk`` is the special case "candidates = all N".
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.common.topk import top_k


class FusionWeights(NamedTuple):
    w_vector: torch.Tensor   # (Q,) or scalar
    w_graph: torch.Tensor


def adaptive_weights(vector_scores: torch.Tensor, *, base_wv: float = 0.6,
                     base_wg: float = 0.4, sensitivity: float = 4.0) -> FusionWeights:
    """vector_scores: (Q, k) descending. Margin = s1 − s2 (top-1 confidence);
    w_v = σ(sensitivity·(margin − 0.05)) blended around the configured base."""
    s = vector_scores
    second = s[:, min(1, s.shape[1] - 1)] if s.shape[1] > 1 else s[:, 0]
    margin = s[:, 0] - second
    margin = torch.nan_to_num(margin, nan=0.0, posinf=1.0, neginf=0.0)
    conf = torch.sigmoid(sensitivity * (margin - 0.05))
    wv = base_wv * (0.5 + conf)             # in [0.5·wv, 1.5·wv]
    wg = base_wg * (1.5 - conf)
    tot = wv + wg
    return FusionWeights(w_vector=wv / tot, w_graph=wg / tot)


def fuse(vector_sim: torch.Tensor, graph_score: torch.Tensor,
         weights: FusionWeights, *, graph_max: Optional[torch.Tensor] = None,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 3 over per-candidate terms.

    vector_sim: (Q, C) cosine similarity in [-1, 1] (−inf for graph-only
    candidates); graph_score: (Q, C) mean per-hop mass. graph_max: (Q, 1)
    normaliser (defaults to the max over the given candidates). valid:
    (Q, C) bool — False entries fuse to −inf."""
    d_v = 0.5 * (1.0 - vector_sim)                    # cosine distance -> [0,1]
    s_v = 1.0 - d_v
    gmax = (graph_score.amax(dim=-1, keepdim=True)
            if graph_max is None else graph_max)
    g = graph_score / torch.clamp_min(gmax, 1e-12)
    dev = graph_score.device
    wv = torch.as_tensor(weights.w_vector, device=dev).reshape(-1, 1)
    wg = torch.as_tensor(weights.w_graph, device=dev).reshape(-1, 1)
    fused = wv * s_v + wg * g
    fused = torch.where(torch.isfinite(vector_sim), fused, wg * g)
    if valid is not None:
        fused = torch.where(valid, fused, float("-inf"))
    return fused


def fuse_topk_sparse(cand_sim: torch.Tensor, cand_graph: torch.Tensor,
                     weights: FusionWeights, k: int, *,
                     graph_max: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scores over an explicit candidate axis -> top-k.

    Returns (scores (Q, k), positions (Q, k)) — positions index the candidate
    axis; the caller owns the candidate-id mapping."""
    fused = fuse(cand_sim, cand_graph, weights, graph_max=graph_max,
                 valid=valid)
    return top_k(fused, k)


def fuse_topk(vector_sim_full: torch.Tensor, graph_score: torch.Tensor,
              weights: FusionWeights, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense fusion: candidates = all N nodes (ids are node positions)."""
    return fuse_topk_sparse(vector_sim_full, graph_score, weights, k)


def scatter_sim(n_nodes: int, ids: torch.Tensor, sims: torch.Tensor) -> torch.Tensor:
    """(Q, k) candidate (ids, sims) -> dense (Q, N) similarity, −inf off the
    candidate set. Duplicate ids keep their maximum."""
    qn = ids.shape[0]
    dense = torch.full((qn, n_nodes), float("-inf"), dtype=sims.dtype,
                       device=sims.device)
    vals = torch.where(ids >= 0, sims, float("-inf"))
    return dense.scatter_reduce(1, ids.clamp(0, n_nodes - 1).long(), vals,
                                reduce="amax")
