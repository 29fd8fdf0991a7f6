"""Wrappers of the two CUDA scan kernels, and the exact top-k built on them.

``probe_scan`` and ``shared_scan`` choose by the tensors' device: on CPU
tensors they run the plain versions in ``ref.py``; on CUDA tensors they
launch the kernels of ``csrc/ivf_topk.cu`` (built by ``kernels/_build.py`` on
first use) or raise. Each keeps a plain int ``launches`` that counts its
kernel launches and nothing else.

Exactness of the probe path (``scan_topk_probe``): the kernel emits
per-chunk (max, argmax) survivors, and the second stage rescores every row
of the top-k chunks. Any true top-k row lives in a chunk whose max is ≥ the
k-th best score, and at most k chunks can have such a max, so the k·chunk
rescored rows contain the exact (quantized-score) top-k.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_topk import ref
from repro_torch.kernels.ivf_topk.ref import NEG, pad_topk, topk_from_chunks

_SRC = Path(__file__).resolve().parent / "csrc" / "ivf_topk.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ivf_probe_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P],
    "ivf_shared_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                        _P],
}
_MAX_D = 8192          # query row + score tile must fit the 48 KB smem default
_MAX_CHUNK = 1024


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


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
    if queries.device.type != "cuda":
        raise ValueError(f"scan kernels run on CUDA or CPU tensors, got "
                         f"{queries.device}")
    return queries.device


def _launch(fn_name: str, device: torch.device, args, out_shape):
    cmax = torch.empty(out_shape, dtype=torch.float32, device=device)
    carg = torch.empty(out_shape, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), fn_name)(*args, cmax.data_ptr(), carg.data_ptr(),
                                       stream)
    if err:
        raise RuntimeError(f"{fn_name}: kernel launch failed with CUDA error "
                           f"{err}")
    return cmax, carg


def probe_scan(queries: torch.Tensor, qsum: torch.Tensor, slab: torch.Tensor,
               aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               probes: torch.Tensor, cap: int, chunk: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe scan (see ``ref.probe_scan`` for the contract)."""
    if queries.device.type == "cpu":
        return ref.probe_scan(queries, qsum, slab, aff, scale, bias, probes,
                              cap, chunk)
    dev = _device_of(queries)
    nq, d = queries.shape
    n_rows = slab.shape[0]
    n_probe = probes.shape[1]
    m = n_probe * cap
    if not (0 < d <= _MAX_D and 0 < chunk <= _MAX_CHUNK and m < 2 ** 31
            and n_rows % cap == 0):
        raise ValueError(f"probe_scan: unsupported d={d} chunk={chunk} "
                         f"rows={n_rows} cap={cap} n_probe={n_probe}")
    _check(queries, "queries", torch.float32, (nq, d), dev)
    _check(qsum, "qsum", torch.float32, (nq,), dev)
    _check(slab, "slab", torch.int8, (n_rows, d), dev)
    for name, t in (("aff", aff), ("scale", scale), ("bias", bias)):
        _check(t, name, torch.float32, (n_rows,), dev)
    _check(probes, "probes", torch.int32, (nq, n_probe), dev)
    vec_ok = int(slab.data_ptr() % 16 == 0)
    out = _launch("ivf_probe_scan", dev,
                  (queries.data_ptr(), qsum.data_ptr(), slab.data_ptr(),
                   aff.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   probes.data_ptr(), nq, d, n_probe, cap, chunk, vec_ok),
                  (nq, -(-m // chunk)))
    probe_scan.launches += 1
    return out


probe_scan.launches = 0


def shared_scan(queries: torch.Tensor, qsum: torch.Tensor, data: torch.Tensor,
                aff: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared-slab scan (see ``ref.shared_scan`` for the contract)."""
    if queries.device.type == "cpu":
        return ref.shared_scan(queries, qsum, data, aff, scale, bias, chunk)
    dev = _device_of(queries)
    nq, d = queries.shape
    n = data.shape[0]
    if not (0 < d <= _MAX_D and 0 < chunk <= _MAX_CHUNK and n < 2 ** 31):
        raise ValueError(f"shared_scan: unsupported d={d} chunk={chunk} n={n}")
    _check(queries, "queries", torch.float32, (nq, d), dev)
    _check(qsum, "qsum", torch.float32, (nq,), dev)
    _check(data, "data", torch.int8, (n, d), dev)
    for name, t in (("aff", aff), ("scale", scale), ("bias", bias)):
        _check(t, name, torch.float32, (n,), dev)
    vec_ok = int(data.data_ptr() % 16 == 0)
    out = _launch("ivf_shared_scan", dev,
                  (queries.data_ptr(), qsum.data_ptr(), data.data_ptr(),
                   aff.data_ptr(), scale.data_ptr(), bias.data_ptr(), nq, n, d,
                   chunk, vec_ok),
                  (nq, -(-n // chunk)))
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
    qsum = q.sum(dim=-1)
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
    m = probes.shape[1] * cap
    qsum = q.sum(dim=-1)
    aff = 128.0 * scale + vmin
    probes = probes.to(torch.int32).contiguous()
    cmax, _ = probe_scan(q, qsum, slab, aff.contiguous(), scale.contiguous(),
                         bias.contiguous(), probes, cap, chunk)
    # stage 2: rescore every row of the top-k chunks exactly
    kc = min(k, cmax.shape[1])
    _, cpos = torch.topk(cmax, kc, dim=1)                            # (Q, kc)
    rows = (cpos.to(torch.int64)[:, :, None] * chunk
            + torch.arange(chunk, device=q.device)[None, None, :])
    rows = rows.reshape(nq, kc * chunk)                              # (Q, R)
    inside = rows < m
    rc = rows.clamp(max=m - 1)
    srow = (torch.gather(probes, 1, rc // cap).to(torch.int64) * cap
            + rc % cap)
    dsel = slab[srow].to(torch.float32)                              # (Q, R, d)
    ssel, vsel, bsel = scale[srow], vmin[srow], bias[srow]
    dots = torch.einsum("qd,qrd->qr", q, dsel)
    scores = dots * ssel + qsum[:, None] * (128.0 * ssel + vsel) + bsel
    scores = torch.where(inside, scores, NEG)
    vals, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    out_rows = torch.gather(rows, 1, pos).to(torch.int32)
    return _dead_to_pad(vals, out_rows, k)
