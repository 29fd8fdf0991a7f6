"""Wrapper of the CUDA flash-decode kernel (the port of
``repro.kernels.decode_attention.ops.decode_attention``).

``decode_attention`` chooses by the tensors' device: on CPU tensors it runs
the plain version in ``ref.py``; on CUDA tensors it launches the kernel of
``csrc/decode_attention.cu`` (built by ``kernels/_build.py`` on first use)
or raises. It keeps the JAX wrapper's layout, q reshaped to
(B, Hkv, G, hd) with head ``h = kv·G + g``, without its padding of S to a
block multiple, which the CUDA kernel does not need. ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)
_MAX_G = 8
_MIN_CHUNK = 64          # positions per split, at least
_sm_count = {}


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point; builds the library on first use."""
    fn = _build.load(_SRC).decode_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def num_splits(device: torch.device, b: int, hkv: int, s: int) -> int:
    """Splits of S per (row, KV head): enough blocks to cover every SM at
    least twice, each split at least ``_MIN_CHUNK`` positions long."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = -(-2 * _sm_count[device] // (b * hkv))
    return max(1, min(want, -(-s // _MIN_CHUNK)))


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
    if s <= 0 or b <= 0 or b * s * hkv * hd >= 2 ** 31:
        raise ValueError(f"decode_attention: unsupported B={b}, S={s}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd) with H = Hkv·G (GQA); k/v (B, S, Hkv, hd); valid (B, S)
    bool. Returns (B, H, hd) in q's dtype: softmax(q·kᵀ/√hd) over the valid
    positions, times v, in fp32; 0 for a row with no valid position."""
    if q.device.type == "cpu":
        b, h, hd = q.shape
        hkv = k.shape[2]
        out = decode_attention_ref(q.reshape(b, hkv, h // hkv, hd), k, v,
                                   valid)
        return out.reshape(b, h, hd)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k, v, valid)
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    splits = num_splits(q.device, b, hkv, s)
    chunk = -(-s // splits)
    splits = -(-s // chunk)                  # no empty trailing split
    ws = torch.empty((b, hkv, splits, g, hd + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention: q is on {q.device}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), b, s, hkv, g, hd,
                 int(q.dtype == torch.bfloat16), splits, chunk, stream)
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
