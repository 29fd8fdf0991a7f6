"""Plain PyTorch versions of the segment sum (the port of
``repro.kernels.segment_reduce.ref.segment_sum_ref``).

``segment_sum_csr_ref`` is the CUDA kernel's contract written out: segment
i of the CSR grouping sums entries ``j`` in ``[rowptr[i], rowptr[i+1])``
(the message ``perm[j]`` when a ``perm`` is given, else ``j``) in fp32, one
``+`` per entry in increasing ``j``, starting from 0, and is rounded once to
the messages' dtype. The loop runs over the position ``k`` within a
segment, over all segments at once (segments ordered by degree, so the
ones still running are a prefix), which is the same sequence of fp32 adds
per output element as the kernel's: the two agree bitwise.

``segment_sum_csr_accumulate_ref`` is the in-place entry's contract (the
backward's gather transposes): the same fp32 sums, each added once, in
fp32, to its listed row of ``out`` and rounded once to ``out``'s dtype.

``segment_sum_ref`` is the reference's drop rule on top of it: ids below 0
or at least ``n_segments`` contribute nothing; the rest are grouped by a
stable sort, so a segment sums its messages in their original order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def csr_from_ids(seg_ids: torch.Tensor, n_segments: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rowptr (n+1,) int32, perm (E,) int32) grouping ``seg_ids`` by
    segment with a stable sort; dropped ids sort past the last segment,
    where no ``rowptr`` range reaches them."""
    ok = (seg_ids >= 0) & (seg_ids < n_segments)
    key = torch.where(ok, seg_ids, n_segments).to(torch.int64)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_segments + 1, device=seg_ids.device)
    rowptr = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return rowptr, order.to(torch.int32)


def _segment_sums_f32(messages: torch.Tensor, rowptr: torch.Tensor,
                      perm: Optional[torch.Tensor]) -> torch.Tensor:
    """The (n, d) fp32 sums of the CSR grouping, before any rounding."""
    n, d = rowptr.numel() - 1, messages.shape[1]
    rowptr = rowptr.to(torch.int64)
    start = rowptr[:-1]
    deg = rowptr[1:] - start
    acc = torch.zeros((n, d), dtype=torch.float32, device=messages.device)
    if n == 0:
        return acc
    order = torch.argsort(deg, descending=True, stable=True)
    start = start[order]
    # running[k]: segments with more than k entries (a prefix of ``order``)
    deg_up = deg[order].flip(0)
    ks = torch.arange(int(deg_up[-1]), device=deg.device)
    running = (n - torch.searchsorted(deg_up, ks, right=True)).tolist()
    for k, c in enumerate(running):
        j = start[:c] + k
        rows = j if perm is None else perm[j].to(torch.int64)
        acc[:c] += messages[rows].to(torch.float32)
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def segment_sum_csr_ref(messages: torch.Tensor, rowptr: torch.Tensor,
                        perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """messages (E, d); rowptr (n+1,) non-decreasing offsets into ``perm``
    (or into ``messages`` when ``perm`` is None) -> (n, d) in the messages'
    dtype."""
    return _segment_sums_f32(messages, rowptr, perm).to(messages.dtype)


def segment_sum_csr_accumulate_ref(messages: torch.Tensor,
                                   rowptr: torch.Tensor,
                                   perm: Optional[torch.Tensor] = None, *,
                                   out: torch.Tensor,
                                   rows: Optional[torch.Tensor] = None,
                                   seg_lo: int = 0) -> torch.Tensor:
    """``out[r_i] = out[r_i] + s_i`` in place and returns ``out``: ``s_i``
    the fp32 sum of segment i (as ``segment_sum_csr_ref`` sums it), added
    in fp32 and rounded once to ``out``'s dtype; ``r_i = rows[i]``, or
    ``seg_lo + i`` without ``rows``. The rows must be distinct."""
    n = rowptr.numel() - 1
    s = _segment_sums_f32(messages, rowptr, perm)
    idx = (torch.arange(seg_lo, seg_lo + n, device=out.device)
           if rows is None else rows.to(torch.int64))
    out[idx] = (out[idx].to(torch.float32) + s).to(out.dtype)
    return out


def segment_sum_ref(messages: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    """messages (E, d); seg_ids (E,) -> (n_segments, d); ids < 0 or
    >= n_segments drop."""
    rowptr, perm = csr_from_ids(seg_ids, n_segments)
    return segment_sum_csr_ref(messages, rowptr, perm)
