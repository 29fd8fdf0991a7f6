"""Plain PyTorch versions of the two scan kernels, plus the top-k helpers.

``probe_scan`` and ``shared_scan`` have the signatures of the CUDA entry
points in ``ops.py`` and compute the same function: for every (query, row)

    score = scale[r] · (q · code[r]) + qsum · aff[r] + bias[r]

with ``code`` the int8 row (centred at -128), ``aff = 128·scale + vmin`` and
``bias`` 0 for a live row and ``NEG`` for a masked one; then, for every
``chunk`` consecutive rows, the max and the first index of the max. Rows past
the end of the scanned range score ``NEG``. The wrappers use these on CPU
tensors; the tests and ``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -3e38   # additive mask bias (sign-safe, unlike -inf)


def chunk_max(scores: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, R) scores -> per-chunk (max (Q, ceil(R/chunk)), argmax as a row
    index). Pads the ragged tail with ``NEG``; ties take the first row."""
    qn, r = scores.shape
    nch = -(-r // chunk)
    pad = nch * chunk - r
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
    vals, arg = scores.reshape(qn, nch, chunk).max(dim=-1)
    base = torch.arange(nch, dtype=torch.int32, device=scores.device) * chunk
    return vals, arg.to(torch.int32) + base[None, :]


def _affine(dots, qsum, aff, scale, bias):
    return dots * scale + qsum * aff + bias


def probe_scan(queries: torch.Tensor, qsum: torch.Tensor, slab: torch.Tensor,
               aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               probes: torch.Tensor, cap: int, chunk: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan. queries (Q, d) fp32; qsum (Q,); slab (K·cap, d) int8;
    aff/scale/bias (K·cap,) fp32; probes (Q, P) int32. Query q's row r is
    slab row ``probes[q, r // cap]·cap + r % cap`` for r < M = P·cap.
    Returns (chunk_max, chunk_arg), each (Q, ceil(M/chunk)); chunk_arg
    indexes the query's own M rows. One query at a time, so the gathered
    rows stay (M, d)."""
    nq = queries.shape[0]
    m = probes.shape[1] * cap
    nch = -(-m // chunk)
    cmax = torch.empty((nq, nch), dtype=torch.float32, device=queries.device)
    carg = torch.empty((nq, nch), dtype=torch.int32, device=queries.device)
    offs = torch.arange(cap, device=queries.device)
    for i in range(nq):
        rows = (probes[i].long()[:, None] * cap + offs[None, :]).reshape(-1)
        dots = slab[rows].to(torch.float32) @ queries[i]
        s = _affine(dots, qsum[i], aff[rows], scale[rows], bias[rows])
        v, a = chunk_max(s[None], chunk)
        cmax[i], carg[i] = v[0], a[0]
    return cmax, carg


def shared_scan(queries: torch.Tensor, qsum: torch.Tensor, data: torch.Tensor,
                aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every query against one shared slab. queries (Q, d) fp32; qsum (Q,);
    data (N, d) int8; aff/scale/bias (N,) fp32. Returns (chunk_max,
    chunk_arg), each (Q, ceil(N/chunk)); chunk_arg indexes data rows."""
    dots = queries.to(torch.float32) @ data.to(torch.float32).T      # (Q, N)
    s = _affine(dots, qsum[:, None], aff[None, :], scale[None, :],
                bias[None, :])
    return chunk_max(s, chunk)


def pad_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Pads (Q, kk ≤ k) descending top-k lists to width k with (-inf, -1) —
    the one sentinel convention every scan/merge path shares."""
    kk = vals.shape[-1]
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids


def topk_from_chunks(chunk_max_: torch.Tensor, chunk_arg: torch.Tensor, k: int):
    """Exact top-k over the chunk survivors (second stage, tiny).

    Clamps k to the available chunk count and pads (-inf, -1)."""
    kk = min(k, chunk_max_.shape[-1])
    vals, pos = torch.topk(chunk_max_, kk, dim=-1)
    ids = torch.gather(chunk_arg, -1, pos)
    return pad_topk(vals, ids, k)
