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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import ops


def _ok(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (segment_ids >= 0) & (segment_ids < num_segments)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


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
