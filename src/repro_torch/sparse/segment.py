"""Segment primitives (the port of ``repro.sparse.segment``), the
message-passing substrate of the GNN path.

``segment_sum`` runs the CUDA segment-sum kernel on CUDA tensors (its plain
version on CPU tensors) through ``kernels.segment_reduce.ops.segment_sum``,
and ``segment_mean`` is built on it, as in the reference. Both are
differentiable, as ``jax.ops.segment_sum`` is: the backward gathers each
row's cotangent by its id (0 for a dropped id). ``segment_max``
and ``segment_softmax`` are plain torch (``scatter_reduce``): the reference
uses ``jax.ops`` there and has no Pallas kernel for them. All four keep the
reference's masking: ids < 0 or >= num_segments contribute nothing, an
empty segment's max is -inf, and softmax denominators are floored at 1e-20.
``csr_by_row`` groups the positions of a gather by the row they read: the
CSR that a gather's transpose (``ops.segment_sum_csr_accumulate``) adds
with, in the GNN engine and in the LM's token lookup.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import ops


def _ok(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (segment_ids >= 0) & (segment_ids < num_segments)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def csr_by_row(idx: torch.Tensor):
    """``idx``'s positions grouped by the row they read, over the distinct
    rows only: ``(rowptr (R + 1,), perm, rows (R,))``, all int32, from a
    stable sort (ties in position order) and ``unique_consecutive``."""
    keys, perm = torch.sort(idx, stable=True)
    rows, counts = torch.unique_consecutive(keys, return_counts=True)
    rowptr = torch.zeros(rows.numel() + 1, dtype=torch.int32,
                         device=idx.device)
    rowptr[1:] = counts.cumsum(0)
    return rowptr, perm.to(torch.int32), rows.to(torch.int32)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (E, ...) -> (num_segments, ...) in data's dtype."""
    flat = data.reshape(data.shape[0], -1).contiguous()
    out = ops.segment_sum(flat, segment_ids, num_segments)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape, dtype=data.dtype, device=data.device)
    c = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(_expand(c, data.dim()), min=1.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (E, ...) -> (num_segments, ...); -inf for an empty segment."""
    ok = _ok(segment_ids, num_segments)
    vals = data[ok]
    idx = _expand(segment_ids[ok].to(torch.int64), data.dim()).expand_as(vals)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, idx, vals, reduce="amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Per-segment softmax over edge logits (GAT-style attention weights)."""
    m = segment_max(logits, segment_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, 0.0)
    at = torch.clamp(segment_ids, 0, num_segments - 1).to(torch.int64)
    e = torch.exp(logits - m[at])
    e = torch.where(_expand(_ok(segment_ids, num_segments), e.dim()), e, 0.0)
    z = segment_sum(e, segment_ids, num_segments)
    return e / torch.clamp(z[at], min=1e-20)
