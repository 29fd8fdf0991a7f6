"""Sparse–dense reranking (paper §3.4: "+20% recall uplift via sparse matrix
fusion").

Dense candidates from the IVF/NSW search are re-scored with a sparse lexical
signal: hashed-term vectors (a CSR-free fixed-width representation — each doc
keeps its ``nnz`` strongest hashed terms) combined with the dense score by
reciprocal-rank fusion (robust to score-scale mismatch, per Exp4Fuse).

The reference's ``repro.core.rerank`` in PyTorch: ranks come from two stable
argsorts (``jnp.argsort`` is stable), the final cut from ``common/topk.py``
(``jax.lax.top_k``'s tie order), and ``hash_terms`` wraps its product to 32
bits as the reference's uint32 arithmetic does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.common.topk import top_k


class SparseVectors(NamedTuple):
    term_ids: torch.Tensor      # (N, nnz) int32, -1 padded — hashed term ids
    term_weights: torch.Tensor  # (N, nnz) fp32


def sparse_overlap_scores(docs: SparseVectors, q_terms: torch.Tensor,
                          q_weights: torch.Tensor,
                          cand_ids: torch.Tensor) -> torch.Tensor:
    """Sparse dot-product between the batch's hashed query terms and each
    candidate doc.

    q_terms: (T,) int32 (one term list for the whole batch, as in the
    reference); q_weights: (T,) fp32; cand_ids: (Q, C) rows into docs.
    Returns (Q, C), -inf where the candidate id is -1. The match tensor is
    (Q, C, nnz, T): nnz and T are small (≤ 32)."""
    n = docs.term_ids.shape[0]
    rows = cand_ids.clamp(0, n - 1).long()
    d_ids = docs.term_ids[rows]                                  # (Q, C, nnz)
    d_w = docs.term_weights[rows]
    q_terms = q_terms.to(device=d_ids.device, dtype=d_ids.dtype)
    q_weights = q_weights.to(device=d_w.device, dtype=torch.float32)
    match = (d_ids[..., :, None] == q_terms) & (d_ids[..., :, None] >= 0)
    contrib = d_w[..., :, None] * q_weights
    s = torch.where(match, contrib, 0.0).sum(dim=(-1, -2))
    return torch.where(cand_ids >= 0, s, float("-inf"))


def _ranks(s: torch.Tensor) -> torch.Tensor:
    """0-based rank of each entry in a stable descending order."""
    order = torch.argsort(-s, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.float32)


def rrf_rerank(dense_scores: torch.Tensor, sparse_scores: torch.Tensor,
               cand_ids: torch.Tensor, *, k: int, c: float = 60.0,
               w_dense: float = 1.0, w_sparse: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reciprocal-rank fusion of the two orderings; returns (scores, ids)."""
    fused = (w_dense / (c + _ranks(dense_scores))
             + w_sparse / (c + _ranks(sparse_scores)))
    fused = torch.where(cand_ids >= 0, fused, float("-inf"))
    vals, pos = top_k(fused, min(k, fused.shape[-1]))
    return vals, torch.gather(cand_ids, -1, pos)


def hash_terms(tokens: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Cheap multiplicative hash of token ids into term buckets: the
    reference's uint32 product, kept to its low 32 bits in int64."""
    t = tokens.to(torch.int64) & 0xFFFFFFFF
    h = ((t * 2654435761) & 0xFFFFFFFF) >> 16
    return (h % n_buckets).to(torch.int32)
