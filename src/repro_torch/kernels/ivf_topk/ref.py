"""Plain PyTorch versions of the two scan kernels, plus the top-k helpers.

``probe_scan`` and ``shared_scan`` have the signatures of the CUDA entry
points in ``ops.py`` and compute the same function: for every (query, row)

    score = scale[r] · (q · code[r]) + qsum · aff[r] + bias[r]

with ``code`` the int8 row (centred at -128), ``aff = 128·scale + vmin`` and
``bias`` 0 for a live row and ``NEG`` for a masked one; then, per segment of
rows (one probed partition of ``cap`` rows; the whole slab for the shared
scan), the max and the first index of the max of every ``chunk``
consecutive rows of the segment, the segment's last chunk holding what is
left. Rows past the end of a chunk score ``NEG``. They compute the dot
products in fp32, the reference's arithmetic; the wrappers use them on CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernels against them.

``probe_scan_limbs`` and ``shared_scan_limbs`` emulate the kernels'
arithmetic instead: the query split into int8 limbs (``ops.query_limbs``),
exact integer sums of limbs × codes (float64 products of integers, exact
below 2^53), the limbs combined in fp32 in the kernel's order. On the card
the kernels give their bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.topk import top_k

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


def segment_chunk_max(scores: torch.Tensor, seg: int, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, S·seg) scores in S segments of ``seg`` rows -> per-chunk (max,
    argmax), each (Q, S·ceil(seg/chunk)): chunk c of segment j sits at
    column j·ceil(seg/chunk) + c and covers the segment's rows
    [c·chunk, min((c+1)·chunk, seg)); the argmax indexes the Q rows' own
    [0, S·seg). When ``seg % chunk == 0`` this is ``chunk_max``."""
    qn, m = scores.shape
    n_seg = m // seg
    v, a = chunk_max(scores.reshape(qn * n_seg, seg), chunk)
    nchp = v.shape[1]
    base = (torch.arange(qn * n_seg, device=scores.device) % n_seg) * seg
    a = a + base.to(torch.int32)[:, None]
    return v.reshape(qn, n_seg * nchp), a.reshape(qn, n_seg * nchp)


def _affine(dots, qsum, aff, scale, bias):
    return dots * scale + qsum * aff + bias


def _probe_rows(probes_i: torch.Tensor, cap: int) -> torch.Tensor:
    offs = torch.arange(cap, device=probes_i.device)
    return (probes_i.long()[:, None] * cap + offs[None, :]).reshape(-1)


def probe_scan(queries: torch.Tensor, qsum: torch.Tensor, slab: torch.Tensor,
               aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               probes: torch.Tensor, cap: int, chunk: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan. queries (Q, d) fp32; qsum (Q,); slab (K·cap, d) int8;
    aff/scale/bias (K·cap,) fp32; probes (Q, P) int32. Query q's row r is
    slab row ``probes[q, r // cap]·cap + r % cap`` for r < M = P·cap.
    Returns (chunk_max, chunk_arg), each (Q, P·ceil(cap/chunk)), chunked per
    probe (``segment_chunk_max``); chunk_arg indexes the query's own M rows.
    One query at a time, so the gathered rows stay (M, d)."""
    nq = queries.shape[0]
    nch = probes.shape[1] * -(-cap // chunk)
    cmax = torch.empty((nq, nch), dtype=torch.float32, device=queries.device)
    carg = torch.empty((nq, nch), dtype=torch.int32, device=queries.device)
    for i in range(nq):
        rows = _probe_rows(probes[i], cap)
        dots = slab[rows].to(torch.float32) @ queries[i]
        s = _affine(dots, qsum[i], aff[rows], scale[rows], bias[rows])
        v, a = segment_chunk_max(s[None], cap, chunk)
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


def _limb_dots(limbs: torch.Tensor, qscale: torch.Tensor,
               codes: torch.Tensor) -> torch.Tensor:
    """(Q, L, dp) int8 limbs × (Q or 1, R, d) int8 codes -> fp32 dot
    products (Q, R), combined as the kernel combines them:
    v = ((c3·2^-7 + c2)·2^-7 + c1)·2^-7 + c0 in fp32, then v·s."""
    d = codes.shape[-1]
    sums = torch.matmul(limbs[:, :, :d].to(torch.float64),
                        codes.to(torch.float64).transpose(-1, -2))  # (Q, L, R)
    parts = sums.to(torch.float32)
    v = parts[:, -1]
    for i in range(parts.shape[1] - 2, -1, -1):
        v = v * 2.0 ** -7 + parts[:, i]
    return v * qscale[:, None]


def probe_scan_limbs(limbs: torch.Tensor, qscale: torch.Tensor,
                     qsum: torch.Tensor, slab: torch.Tensor, aff: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     probes: torch.Tensor, cap: int, chunk: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``probe_scan`` in the kernel's limb arithmetic (limbs, qscale from
    ``ops.query_limbs``)."""
    nq = limbs.shape[0]
    nch = probes.shape[1] * -(-cap // chunk)
    cmax = torch.empty((nq, nch), dtype=torch.float32, device=limbs.device)
    carg = torch.empty((nq, nch), dtype=torch.int32, device=limbs.device)
    for i in range(nq):
        rows = _probe_rows(probes[i], cap)
        dots = _limb_dots(limbs[i:i + 1], qscale[i:i + 1], slab[rows][None])
        s = _affine(dots[0], qsum[i], aff[rows], scale[rows], bias[rows])
        v, a = segment_chunk_max(s[None], cap, chunk)
        cmax[i], carg[i] = v[0], a[0]
    return cmax, carg


def shared_scan_limbs(limbs: torch.Tensor, qscale: torch.Tensor,
                      qsum: torch.Tensor, data: torch.Tensor,
                      aff: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``shared_scan`` in the kernel's limb arithmetic."""
    dots = _limb_dots(limbs, qscale, data[None])
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
    vals, pos = top_k(chunk_max_, kk)
    ids = torch.gather(chunk_arg, -1, pos)
    return pad_topk(vals, ids, k)
