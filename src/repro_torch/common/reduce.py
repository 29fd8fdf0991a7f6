"""Row sums whose summation order does not depend on the number of rows.

A search's bytes must not depend on the batch it rode in (the serving
contract of ``serving/retrieval.py``), but on a CUDA device a library
reduction or matmul picks its kernel, or its split of a row across
threads, from the whole shape: ``torch.einsum`` and ``@`` go to cuBLAS,
whose kernel choice changes with the number of rows, and PyTorch's
reduction kernel widens its per-row thread group when there are few rows
(under 16) to reduce. ``row_sum`` keeps every reduced extent at 32 or
less, where each row is one warp-wide tree whatever the row count: the
last axis is cut into runs of 32 (zero-padded), each run summed, and the
partial sums summed the same way until one is left.
"""
from __future__ import annotations

import torch

_RUN = 32


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, in an order fixed by its length alone."""
    while x.shape[-1] > _RUN:
        pad = -x.shape[-1] % _RUN
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        x = x.reshape(x.shape[:-1] + (-1, _RUN)).sum(dim=-1)
    return x.sum(dim=-1)


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products over the last axis of ``a`` and ``b`` (broadcast), in
    ``row_sum``'s order."""
    return row_sum(a * b)
