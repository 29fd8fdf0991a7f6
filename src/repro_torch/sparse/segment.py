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
with, in the GNN engine, in the LM's token lookup and in ``gather_rows``,
a row gather whose transpose is that addition (no atomics: the same bits
on every run). ``segment_softmax`` reads its denominators through it, and
its shift (each segment's max) takes no gradient: the softmax does not
depend on it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.segment_reduce import ops
from repro_torch.roofline import trace


def _ok(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (segment_ids >= 0) & (segment_ids < num_segments)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def csr_by_row(idx: torch.Tensor, n_rows: Optional[int] = None):
    """``idx``'s positions grouped by the row they read, over the distinct
    rows only: ``(rowptr (R + 1,), perm, rows (R,))``, all int32, from a
    stable sort (ties in position order) and ``unique_consecutive``.

    On meta tensors (the dry run's traces), which hold no ids, R is the
    worst case, every id distinct (R = ``idx.numel()``, at most the
    ``n_rows`` of the table read, when given): an upper bound of the rows
    the transposes touch, noted in the dry-run counter.
    ``unique_consecutive``, which has no meta implementation, is counted
    by its bytes."""
    keys, perm = torch.sort(idx, stable=True)
    if idx.device.type == "meta":
        trace.assume("csr_by_row on meta tensors: every id distinct (the "
                     "worst case)")
        n = keys.numel() if n_rows is None else min(keys.numel(), n_rows)
        rows = torch.empty(n, dtype=keys.dtype, device=idx.device)
        counts = torch.empty(n, dtype=torch.int64, device=idx.device)
        trace.note_op("unique_consecutive", keys.numel() * keys.element_size(),
                      n * keys.element_size() + n * 8)
    else:
        rows, counts = torch.unique_consecutive(keys, return_counts=True)
    rowptr = torch.zeros(rows.numel() + 1, dtype=torch.int32,
                         device=idx.device)
    rowptr[1:] = counts.cumsum(0)
    return rowptr, perm.to(torch.int32), rows.to(torch.int32)


class _GatherAdd(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose transpose adds the cotangents
    into a zeroed gradient of ``table``'s shape with the in-place kernel,
    over the distinct rows ``idx`` reads (``csr_by_row``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        if idx.numel():
            rowptr, perm, rows = csr_by_row(idx, ctx.shape[0])
            ops.segment_sum_csr_accumulate(grad.contiguous(), rowptr, perm,
                                           out=out, rows=rows)
        return out, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 2-D ``table`` and ids in range; under grad its
    transpose adds with the in-place kernel (``_GatherAdd``)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherAdd.apply(table, idx)
    return table.index_select(0, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """data (E, ...) -> (num_segments, ...) in data's dtype."""
    flat = (data[:, None] if data.dim() == 1 else data.flatten(1)).contiguous()
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
    m = segment_max(logits.detach(), segment_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, 0.0)
    at = torch.clamp(segment_ids, 0, num_segments - 1).to(torch.int64)
    e = torch.exp(logits - m[at])
    e = torch.where(_expand(_ok(segment_ids, num_segments), e.dim()), e, 0.0)
    z = segment_sum(e, segment_ids, num_segments)
    z2 = z[:, None] if z.dim() == 1 else z.flatten(1)
    denom = gather_rows(z2, at).reshape(e.shape)
    return e / torch.clamp(denom, min=1e-20)
