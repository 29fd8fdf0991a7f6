"""Wrappers of the two CUDA scan kernels, and the exact top-k built on them.

``probe_scan`` and ``shared_scan`` choose by the tensors' device: on CPU
tensors they run the plain versions in ``ref.py``; on CUDA tensors they
launch the kernels of ``csrc/ivf_topk.cu`` (built by ``kernels/_build.py`` on
first use) or raise. Each keeps a plain int ``launches`` that counts its
kernel launches and nothing else.

The kernels multiply on the tensor cores in int8: ``query_limbs`` splits
each fp32 query into ``N_LIMBS`` int8 limbs and one fp32 step (plain torch,
on the queries' device, no host sync); the codes stay exact. The probe
wrapper also sorts the (query, probe) pairs by partition on the device, so
the kernel reads each probed partition once per batch.

Exactness of the probe path (``scan_topk_probe``): the kernel emits
per-chunk (max, argmax) survivors, and the second stage rescores every row
of the top-k chunks. Any true top-k row lives in a chunk whose max is ≥ the
k-th best score, and at most k chunks can have such a max, so the k·chunk
rescored rows contain the exact (quantized-score) top-k. This holds for any
split of the rows into chunks, so also for chunks cut at every probe's
segment end.

On meta tensors (the dry run's traces) the scans run the CUDA route's
checks and set-up (limbs, the probe order) and allocate its outputs, and
compute nothing. Each scan call is one region of the dry-run counter
(``roofline.trace``) on every route, counted by the formula of its bound:
the int8 tensor-core operations of the limb passes, each probed partition
(meta: as many as the probes could name, the worst case) or shared row
read once with its 12 bytes of affine terms, the queries, and the chunk
outputs written.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.common.reduce import row_dot, row_sum
from repro_torch.common.topk import top_k
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_topk import ref
from repro_torch.kernels.ivf_topk.ref import NEG, pad_topk, topk_from_chunks
from repro_torch.roofline import trace

_SRC = Path(__file__).resolve().parent / "csrc" / "ivf_topk.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ivf_probe_scan": [_P] * 9 + [_I] * 7 + [_P] * 3,
    "ivf_shared_scan": [_P] * 7 + [_I] * 5 + [_P] * 3,
}
# int8 limbs per query; the kernel's kLimbs
N_LIMBS = 4
# a row tile and one stage of 16 pairs' limbs (and, for a chunk that is
# not a power of two ≤ 32, a score tile) must fit the 227 KB of shared
# memory a block can have, at d rounded up to 32, + 16 bytes per row:
# 128-row tiles up to d = 1,152, 64-row tiles up to d = 1,728
_MAX_D = 1728
_MAX_CHUNK = 128       # a chunk lies within one row tile: ≤ 64 past d = 1,152


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def query_limbs(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splits fp32 queries (Q, d) into int8 limbs (Q, N_LIMBS, dp) — dp is d
    rounded up to 32, zero past d — and a step s (Q,) fp32 with

        q ≈ s · Σ_i a_i · 2^(-7 i),   s = max|q| / 127,

    a_0 = round(q / s) in [-127, 127] and each later limb the rounded
    residual of the ones before, ×128^i, in [-64, 64]:
    Σ_i a_i 2^(-7 i) = round(t · 2^(7 (L-1))) / 2^(7 (L-1)) for t = q / s.
    Per element the residual is at most ``limb_residual(s)`` =
    s · 2^-(7·N_LIMBS - 6). A zero row has s = 0 and all limbs 0. The
    products and the rounding run in float64 (|t · 2^21| < 2^28), so the
    bound holds for the fp32 step as it is stored, up to float64 rounding.
    About ten small launches, no host sync."""
    nq, d = queries.shape
    s = torch.linalg.vector_norm(queries, float("inf"), dim=1) / 127.0
    # R_i = round(q · 128^i / s) holds the first i + 1 limbs (float64:
    # |R_3| < 2^28, exact), a_i = R_i - 128 · R_(i-1); a zero row gives
    # 0 · inf = nan -> 0
    w = _powers(queries.device)[None] / s[:, None, None]
    r = (queries[:, None, :] * w).round_().nan_to_num_(0.0)
    limbs = torch.zeros((nq, N_LIMBS, -(-d // 32) * 32), dtype=torch.int8,
                        device=queries.device)
    limbs[:, :, :d] = torch.cat(
        [r[:, :1], torch.sub(r[:, 1:], r[:, :-1], alpha=128.0)], dim=1)
    return limbs, s


_POWERS = {}


def _powers(device: torch.device) -> torch.Tensor:
    """(N_LIMBS, 1) float64: 128^i, kept per device."""
    key = str(device)
    if key not in _POWERS:
        _POWERS[key] = (128.0 ** torch.arange(N_LIMBS, dtype=torch.float64,
                                              device=device))[:, None]
    return _POWERS[key]


def limb_residual(s: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |q - s·Σ a_i 2^(-7 i)| for step(s) s."""
    return s.to(torch.float64) * 2.0 ** -(7 * N_LIMBS - 6)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device_of(queries: torch.Tensor) -> torch.device:
    if queries.device.type not in ("cuda", "meta"):
        raise ValueError(f"scan kernels run on CUDA or CPU tensors, got "
                         f"{queries.device}")
    return queries.device


def _check_rows(fn: str, queries, qsum, data, aff, scale, bias, chunk):
    """Checks the operands both kernels share; returns (device, nq, d, n)."""
    dev = _device_of(queries)
    nq, d = queries.shape
    n = data.shape[0]
    max_chunk = _MAX_CHUNK if d <= 1152 else 64
    if not (0 < d <= _MAX_D and 0 < chunk <= max_chunk and n < 2 ** 31):
        raise ValueError(f"{fn}: unsupported d={d} chunk={chunk} rows={n} "
                         f"(d ≤ {_MAX_D}, chunk ≤ {max_chunk})")
    _check(queries, "queries", torch.float32, (nq, d), dev)
    _check(qsum, "qsum", torch.float32, (nq,), dev)
    _check(data, "slab", torch.int8, (n, d), dev)
    for name, t in (("aff", aff), ("scale", scale), ("bias", bias)):
        _check(t, name, torch.float32, (n,), dev)
    return dev, nq, d, n


def _launch(fn_name: str, device: torch.device, args, out_shape):
    cmax = torch.empty(out_shape, dtype=torch.float32, device=device)
    carg = torch.empty(out_shape, dtype=torch.int32, device=device)
    trace.peak_here()            # the limbs, the probe order and the outputs
    if device.type == "meta":
        return cmax, carg
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), fn_name)(*args, cmax.data_ptr(), carg.data_ptr(),
                                       stream)
    if err:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error "
                           f"{err}")
    return cmax, carg


def probe_order(probes: torch.Tensor, n_parts: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse probe list, on the probes' device: (order (Q·P,) int64,
    the pair ids q·P + j sorted by partition probes[q, j], ties in id
    order; offsets (n_parts + 1,) int32, partition p's run being
    order[offsets[p]:offsets[p + 1]])."""
    parts, order = torch.sort(probes.reshape(-1), stable=True)
    # searchsorted, not bincount: bincount on CUDA reads its input's max
    # back to the host
    bounds = torch.arange(n_parts + 1, dtype=parts.dtype, device=probes.device)
    return order, torch.searchsorted(parts, bounds, out_int32=True)


def probe_scan(queries: torch.Tensor, qsum: torch.Tensor, slab: torch.Tensor,
               aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               probes: torch.Tensor, cap: int, chunk: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan (see ``ref.probe_scan`` for the contract). Every entry
    of ``probes`` must name a partition, 0 ≤ p < K·cap / cap."""
    with trace.kernel("ivf_probe_scan", lambda: _probe_work(
            queries, slab, probes, cap, chunk)):
        return _probe_route(queries, qsum, slab, aff, scale, bias, probes,
                            cap, chunk)


def _probe_work(queries, slab, probes, cap, chunk):
    nq, d = queries.shape
    n_probe = probes.shape[1]
    if queries.device.type == "meta":
        trace.assume("ivf_probe_scan on meta tensors: every probe names a "
                     "distinct partition (the worst case)")
        distinct = min(slab.shape[0] // max(cap, 1), nq * n_probe)
    else:
        distinct = int(torch.unique(probes).numel())
    nchp = -(-cap // chunk)
    nbytes = (distinct * cap * (d + 12) + nq * d * 4 + nq * 4
              + nq * n_probe * 4 + 2 * nq * n_probe * nchp * 4)
    return 2.0 * N_LIMBS * nq * n_probe * cap * d, "int8", nbytes


def _probe_route(queries, qsum, slab, aff, scale, bias, probes, cap, chunk):
    if queries.device.type == "cpu":
        return ref.probe_scan(queries, qsum, slab, aff, scale, bias, probes,
                              cap, chunk)
    dev, nq, d, n_rows = _check_rows("probe_scan", queries, qsum, slab, aff,
                                     scale, bias, chunk)
    n_probe = probes.shape[1]
    n_parts = n_rows // cap if cap > 0 else 0
    if not (cap > 0 and n_rows % cap == 0 and n_probe * cap < 2 ** 31
            and 0 < n_parts <= 65535):
        raise ValueError(f"probe_scan: unsupported rows={n_rows} cap={cap} "
                         f"n_probe={n_probe}")
    _check(probes, "probes", torch.int32, (nq, n_probe), dev)
    limbs, qscale = query_limbs(queries)
    order, offsets = probe_order(probes, n_parts)
    vec_ok = int(slab.data_ptr() % 16 == 0 and d % 16 == 0)
    out = _launch("ivf_probe_scan", dev,
                  (limbs.data_ptr(), qscale.data_ptr(), qsum.data_ptr(),
                   slab.data_ptr(), aff.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                   nq, d, n_parts, n_probe, cap, chunk, vec_ok),
                  (nq, n_probe * -(-cap // chunk)))
    if dev.type == "cuda":
        probe_scan.launches += 1
    return out


probe_scan.launches = 0


def shared_scan(queries: torch.Tensor, qsum: torch.Tensor, data: torch.Tensor,
                aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared-slab scan (see ``ref.shared_scan`` for the contract)."""
    with trace.kernel("ivf_shared_scan", lambda: _shared_work(
            queries, data, chunk)):
        return _shared_route(queries, qsum, data, aff, scale, bias, chunk)


def _shared_work(queries, data, chunk):
    nq, d = queries.shape
    n = data.shape[0]
    nbytes = (n * (d + 12) + nq * d * 4 + nq * 4
              + 2 * nq * -(-n // chunk) * 4)
    return 2.0 * N_LIMBS * nq * n * d, "int8", nbytes


def _shared_route(queries, qsum, data, aff, scale, bias, chunk):
    if queries.device.type == "cpu":
        return ref.shared_scan(queries, qsum, data, aff, scale, bias, chunk)
    dev, nq, d, n = _check_rows("shared_scan", queries, qsum, data, aff,
                                scale, bias, chunk)
    limbs, qscale = query_limbs(queries)
    vec_ok = int(data.data_ptr() % 16 == 0 and d % 16 == 0)
    out = _launch("ivf_shared_scan", dev,
                  (limbs.data_ptr(), qscale.data_ptr(), qsum.data_ptr(),
                   data.data_ptr(), aff.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), nq, n, d, chunk, vec_ok),
                  (nq, -(-n // chunk)))
    if dev.type == "cuda":
        shared_scan.launches += 1
    return out


shared_scan.launches = 0


def _dead_to_pad(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Masked survivors (score ≈ NEG) become (-inf, -1); pad to width k."""
    dead = vals <= NEG * 0.5
    vals = torch.where(dead, torch.full_like(vals, float("-inf")), vals)
    ids = torch.where(dead, torch.full_like(ids, -1), ids)
    return pad_topk(vals, ids, k)


def scan_topk_quantized(queries: torch.Tensor, data_i8: torch.Tensor,
                        vmin: torch.Tensor, scale: torch.Tensor,
                        valid: torch.Tensor, *, k: int, chunk: int = 128):
    """Top-k over a quantized slab shared by all queries.

    queries (Q, d) fp32; data_i8 (N, d) int8; vmin/scale (N,); valid (N,)
    bool. Returns (scores (Q, k), row ids (Q, k)) — descending, -inf/-1
    padded."""
    q = queries.to(torch.float32).contiguous()
    qsum = row_sum(q)
    aff = 128.0 * scale + vmin
    bias = torch.where(valid, 0.0, NEG).to(torch.float32)
    cmax, carg = shared_scan(q, qsum, data_i8.contiguous(), aff.contiguous(),
                             scale.contiguous(), bias.contiguous(), chunk)
    vals, ids = topk_from_chunks(cmax, carg, min(k, cmax.shape[1]))
    return _dead_to_pad(vals, ids, k)


def scan_topk_probe(queries: torch.Tensor, slab: torch.Tensor,
                    vmin: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, probes: torch.Tensor, cap: int, *,
                    k: int, chunk: int = 16):
    """Exact top-k over each query's probed partitions of the flat slab.

    queries (Q, d) fp32; slab (K·cap, d) int8; vmin/scale/bias (K·cap,)
    fp32 (bias: 0 live, NEG masked — shared by every query); probes (Q, P).
    Returns (scores (Q, k), rows (Q, k)) — descending; ``rows`` index each
    query's own scanned range [0, P·cap) like the reference's gathered
    slab axis; -inf/-1 padded."""
    q = queries.to(torch.float32).contiguous()
    nq = q.shape[0]
    qsum = row_sum(q)
    aff = 128.0 * scale + vmin
    probes = probes.to(torch.int32).contiguous()
    cmax, _ = probe_scan(q, qsum, slab, aff.contiguous(), scale.contiguous(),
                         bias.contiguous(), probes, cap, chunk)
    # stage 2: rescore every row of the top-k chunks exactly. Chunks are cut
    # per probe (``ref.segment_chunk_max``): chunk c of probe j covers the
    # query's own rows j·cap + [c·chunk, min((c + 1)·chunk, cap))
    nchp = -(-cap // chunk)
    kc = min(k, cmax.shape[1])
    _, cpos = top_k(cmax, kc)                                        # (Q, kc)
    cpos = cpos.to(torch.int64)
    within = ((cpos % nchp)[:, :, None] * chunk
              + torch.arange(chunk, device=q.device)[None, None, :])
    inside = (within < cap).reshape(nq, kc * chunk)
    rows = ((cpos // nchp)[:, :, None] * cap
            + within.clamp(max=cap - 1)).reshape(nq, kc * chunk)    # (Q, R)
    srow = (torch.gather(probes, 1, rows // cap).to(torch.int64) * cap
            + rows % cap)
    dsel = slab[srow].to(torch.float32)                              # (Q, R, d)
    ssel, vsel, bsel = scale[srow], vmin[srow], bias[srow]
    dots = row_dot(q[:, None, :], dsel)
    scores = dots * ssel + qsum[:, None] * (128.0 * ssel + vsel) + bsel
    scores = torch.where(inside, scores, NEG)
    vals, pos = top_k(scores, min(k, scores.shape[1]))
    out_rows = torch.gather(rows, 1, pos).to(torch.int32)
    return _dead_to_pad(vals, out_rows, k)
