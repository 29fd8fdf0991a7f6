"""Wrapper of the CUDA flash-decode kernel (the port of
``repro.kernels.decode_attention.ops.decode_attention``).

``decode_attention`` chooses by the tensors' device: on CPU tensors it runs
the plain version in ``ref.py``; on CUDA tensors it launches the kernel of
``csrc/decode_attention.cu`` (built by ``kernels/_build.py`` on first use)
or raises. It keeps the JAX wrapper's layout, q reshaped to
(B, Hkv, G, hd) with head ``h = kv·G + g``, without its padding of S to a
block multiple, which the CUDA kernel does not need. One call is one
kernel launch: the kernel's last block per (row, KV head) merges the
splits, counting arrivals in a small int32 buffer kept per device and
stream (the kernel leaves it at 0). ``launches`` counts kernel launches and
nothing else.

On meta tensors (the dry run's traces) it runs the CUDA route's checks and
allocates the CUDA route's output and split workspace (planned for the
H100's ``H100_SMS`` streaming multiprocessors), and computes nothing.
Every route opens the dry-run counter's kernel region (``roofline.trace``):
a call counts the formula of the kernel's bound, each valid K and V row
read once, the mask, q in and out (meta: every position valid, the worst
case).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.roofline import trace

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (16, 64, 128)
_MAX_G = 8
THREADS = 128            # per block (csrc kThreads)
TILE = 64                # positions per tile (csrc kTile)
MAX_TILES = 8            # tiles per split, at most (csrc kMaxTiles)
MAX_SPLITS = 512         # splits per (row, KV head), at most (csrc kMaxSplits)
MAX_S = MAX_SPLITS * MAX_TILES * TILE
BLOCKS_PER_SM = 4        # splits planned for at least this many blocks per SM
H100_SMS = 132           # the meta route's plan: an H100 SXM's SMs
_sm_count: Dict[torch.device, int] = {}
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry points; builds the library on first use."""
    lib = _build.load(_SRC)
    lib.decode_attention.argtypes = _ARGTYPES
    lib.decode_attention.restype = ctypes.c_int
    lib.decode_attention_smem.argtypes = [_I, _I, _I]
    lib.decode_attention_smem.restype = ctypes.c_int
    return lib


def plan(b: int, hkv: int, s: int, sm_count: int) -> Tuple[int, int]:
    """(tiles per split, splits) for B·Hkv rows of S positions, from the
    shapes alone: the longest splits (up to ``MAX_TILES`` tiles of
    ``TILE`` positions, in powers of two) that still give at least
    ``BLOCKS_PER_SM`` blocks per SM, so that short and ragged histories,
    whose late splits are empty, still leave several working blocks on
    each SM; one tile per split when even that falls short, or the
    fewest tiles that keep the splits within ``MAX_SPLITS``."""
    n_tiles = -(-s // TILE)
    want = BLOCKS_PER_SM * sm_count
    tiles = 1
    while -(-n_tiles // tiles) > MAX_SPLITS:
        tiles *= 2
    while (tiles * 2 <= min(MAX_TILES, n_tiles)
           and b * hkv * -(-n_tiles // (tiles * 2)) >= want):
        tiles *= 2
    return tiles, -(-n_tiles // tiles)


def _sms(device: torch.device) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device]


def launch_plan(q: torch.Tensor, k: torch.Tensor) -> dict:
    """What a call on CUDA tensors q (B, H, hd), k (B, S, Hkv, hd) launches
    (for reports): tile length, tiles per split, splits, blocks, threads
    and dynamic shared memory per block."""
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    tiles, splits = plan(b, hkv, s, _sms(q.device))
    return dict(tile=TILE, tiles_per_split=tiles, splits=splits,
                blocks=splits * hkv * b, threads=THREADS,
                smem_bytes=_lib().decode_attention_smem(
                    h // hkv, hd, int(q.dtype == torch.bfloat16)))


def _arrival_counters(device: torch.device, stream: int,
                      n: int) -> torch.Tensor:
    """n int32 zeros for the kernel's arrival counts on this stream (the
    kernel resets each to 0, so the buffer is zeroed only when made)."""
    key = (device.index, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _arrivals[key] = buf
    return buf


def _check(q, k, v, valid) -> None:
    dev = q.device
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, hd) and k/v "
                         f"(B, S, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v), ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: q/k/v must share one of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"decode_attention: valid must be bool, got "
                         f"{valid.dtype}")
    if (tuple(k.shape) != (b, s, hkv, hd) or tuple(v.shape) != tuple(k.shape)
            or tuple(valid.shape) != (b, s)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)} do not agree")
    if hd not in _HEAD_DIMS or hkv <= 0 or h % hkv or not 0 < h // hkv <= _MAX_G:
        raise ValueError(f"decode_attention: the kernel takes hd in "
                         f"{_HEAD_DIMS} and 1 <= H/Hkv <= {_MAX_G}, got "
                         f"hd={hd}, H={h}, Hkv={hkv}")
    if s <= 0 or b <= 0 or s > MAX_S or b > 65535:
        raise ValueError(f"decode_attention: unsupported B={b}, S={s}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd) with H = Hkv·G (GQA); k/v (B, S, Hkv, hd); valid (B, S)
    bool. Returns (B, H, hd) in q's dtype: softmax(q·kᵀ/√hd) over the valid
    positions, times v, in fp32; 0 for a row with no valid position."""
    with trace.kernel("decode_attention", lambda: _work(q, k, valid)):
        return _route(q, k, v, valid)


def _work(q, k, valid):
    """(flops, class, bytes) of one call: each valid K and V row read once,
    the mask, q in and out; two fp32 products a valid (position, head)."""
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        trace.assume("decode_attention on meta tensors: every cache position "
                     "valid (the worst case)")
        n_valid = b * s
    else:
        n_valid = int(valid.sum())
    es = q.element_size()
    nbytes = n_valid * hkv * hd * 2 * es + b * s + 2 * b * h * hd * es
    return 4.0 * n_valid * h * hd, "fp32", nbytes


def _route(q, k, v, valid):
    if q.device.type == "cpu":
        b, h, hd = q.shape
        hkv = k.shape[2]
        out = decode_attention_ref(q.reshape(b, hkv, h // hkv, hd), k, v,
                                   valid)
        return out.reshape(b, h, hd)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k, v, valid)
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    meta = q.device.type == "meta"
    if not meta and q.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {q.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    tiles, splits = plan(b, hkv, s, H100_SMS if meta else _sms(q.device))
    ws = torch.empty((b, hkv, splits, g, hd + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    trace.peak_here()               # the workspace and the output at once
    if meta:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    arrivals = _arrival_counters(q.device, stream, b * hkv)
    err = _lib().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        ws.data_ptr(), arrivals.data_ptr(), out.data_ptr(), b, s, hkv, g, hd,
        int(q.dtype == torch.bfloat16), tiles, splits, stream)
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
