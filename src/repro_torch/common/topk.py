"""Top-k with ``jax.lax.top_k``'s order: descending values, ties broken
toward the lower position. ``torch.topk`` promises no order among equal
values, and the reference relies on this one (its stable-before-delta
merges, the lowest id among equal fused scores), so every port site where
the order can surface in a result takes its top-k here.
"""
from __future__ import annotations

from typing import Tuple

import torch

# up to this many columns a stable sort is one launch and cheap; wider rows
# (the delta's scan plane, the traversal frontier) take the O(N) path
_SORT_MAX = 2048
# the O(N) path counts the k-th value's ties in blocks of this many columns
_BLOCK = 256

# a float's bits, read as a signed integer of its width, give its total
# order once the magnitude bits of negative values are flipped
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Integers that sort as ``x`` does in the IEEE total order: ``-0.0``
    below ``+0.0``, every other pair of numbers as ``x`` itself."""
    idt = _INT_VIEW.get(x.dtype)
    if idt is None:
        return x
    bits = x.contiguous().view(idt)
    mag = torch.iinfo(idt).max
    return torch.where(bits < 0, bits ^ mag, bits)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis of ``x``: (values,
    int64 positions), values descending, equal values in ascending
    position.

    Rows of up to ``_SORT_MAX`` columns take a stable descending sort.
    Wider rows take an O(N) path with no full sort: ``torch.topk`` gives
    the k-th value; the entries above it are ``torch.topk``'s own (as a
    set); the remaining places go to the entries equal to it in position
    order — the j-th of them found by a binary search over per-block tie
    counts, then over the running count inside its block; a stable sort
    of the k survivors, taken in position order, orders them. Floats are
    ranked by ``_order_key``; the values returned are ``x``'s own."""
    key = _order_key(x)
    if key is not x:
        _, pos = top_k(key, k)
        return torch.gather(x, -1, pos), pos
    n = x.shape[-1]
    lead = x.shape[:-1]
    if k == 0 or n == 0:
        return torch.topk(x, k, dim=-1)
    if n <= _SORT_MAX:
        vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], pos[..., :k]
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    dev = x.device
    vals, pos = torch.topk(x2, k, dim=1)
    kth = vals[:, -1:]
    # torch.topk sorts its output: the first n_above places hold the
    # entries above the k-th value, the rest entries equal to it
    above = vals > kth
    n_above = above.sum(dim=1, keepdim=True, dtype=torch.int32)
    nb = -(-n // _BLOCK)
    eq = torch.nn.functional.pad(x2 == kth, (0, nb * _BLOCK - n))
    eq = eq.view(rows, nb, _BLOCK)
    cnt = eq.sum(dim=2, dtype=torch.int32)                       # (R, nb)
    ccum = torch.cumsum(cnt, dim=1, dtype=torch.int32)
    # place i >= n_above takes the (i - n_above + 1)-th tie
    want = (torch.arange(1, k + 1, dtype=torch.int32, device=dev)[None, :]
            - n_above).clamp(min=1).contiguous()                # (R, k)
    blk = torch.searchsorted(ccum, want).clamp(max=nb - 1)      # (R, k)
    rank = want - (torch.gather(ccum, 1, blk) - torch.gather(cnt, 1, blk))
    inside = torch.cumsum(eq[torch.arange(rows, device=dev)[:, None], blk],
                          dim=2, dtype=torch.int32)             # (R, k, B)
    off = torch.searchsorted(inside, rank[:, :, None]).squeeze(2)
    eq_pos = (blk * _BLOCK + off).clamp(max=n - 1)
    cand = torch.sort(torch.where(above, pos, eq_pos), dim=1).values
    cv, order = torch.sort(torch.gather(x2, 1, cand), dim=1, descending=True,
                           stable=True)
    cand = torch.gather(cand, 1, order)
    return cv.reshape(lead + (k,)), cand.reshape(lead + (k,))
