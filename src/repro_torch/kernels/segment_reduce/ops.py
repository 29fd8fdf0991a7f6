"""Wrapper of the CUDA segment-sum kernel (the port of
``repro.kernels.segment_reduce.ops.segment_sum_mm``).

Both entry points choose by the messages' device: on CPU tensors they run
the plain versions in ``ref.py``; on CUDA tensors they launch the kernel of
``csrc/segment_reduce.cu`` (built by ``kernels/_build.py`` on first use) or
raise ``ValueError`` for an input the kernel does not take.

- ``segment_sum(messages, seg_ids, n_segments)`` takes unsorted ids with
  the reference's drop rule (ids < 0 or >= n_segments contribute nothing):
  it groups them with a stable sort (``ref.csr_from_ids``, set-up in plain
  torch) and runs ``segment_sum_csr`` with the resulting ``perm``.
- ``segment_sum_csr(messages, rowptr, perm=None, out=None, seg_lo=0)`` is
  for callers that already hold the grouping (``LocalExec``'s destination-
  sorted edges): it writes rows ``[seg_lo, seg_lo + n)`` of ``out``.

``segment_sum_csr.launches`` counts kernel launches and nothing else; both
entry points launch through it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce.ref import (
    csr_from_ids, segment_sum_csr_ref, segment_sum_ref)

_SRC = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_DTYPES = (torch.float32, torch.bfloat16)
_INT32_LIMIT = 2 ** 31 - 2 ** 20     # rows, segments and entries (int32)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point; builds the library on first use."""
    fn = _build.load(_SRC).segment_sum_csr
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _vector_width(d: int, elem_size: int, *ptrs: int) -> int:
    """Elements per lane load: the widest of 16/8/4/2 bytes (at most 4
    fp32 or 8 bf16) that divides a row and aligns every pointer."""
    for nbytes in (16, 8, 4, 2):
        v = nbytes // elem_size
        if v >= 1 and d % v == 0 and all(p % nbytes == 0 for p in ptrs):
            return v
    return 1


def _check(messages, rowptr, perm, out, seg_lo) -> None:
    dev = messages.device
    if messages.dim() != 2:
        raise ValueError(f"segment_sum: messages must be (E, d), got "
                         f"{tuple(messages.shape)}")
    e, d = messages.shape
    n = rowptr.numel() - 1
    if e >= _INT32_LIMIT or n + 1 >= _INT32_LIMIT or (
            perm is not None and perm.numel() >= _INT32_LIMIT):
        raise ValueError(f"segment_sum: E={e}, n={n} exceed the kernel's "
                         f"int32 offsets (< {_INT32_LIMIT})")
    if messages.dtype not in _DTYPES:
        raise ValueError(f"segment_sum: the kernel takes {_DTYPES}, got "
                         f"{messages.dtype}")
    if not messages.is_contiguous():
        raise ValueError("segment_sum: messages must be contiguous")
    if d <= 0:
        raise ValueError(f"segment_sum: d={d}")
    for name, t in (("rowptr", rowptr), ("perm", perm)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"segment_sum: {name} on {t.device}, messages "
                             f"on {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous int32")
    if out.device != dev or out.dtype != messages.dtype:
        raise ValueError(f"segment_sum: out is {out.dtype} on {out.device}, "
                         f"messages {messages.dtype} on {dev}")
    if (out.dim() != 2 or out.shape[1] != d or not out.is_contiguous()
            or not 0 <= seg_lo <= out.shape[0] - n):
        raise ValueError(f"segment_sum: out {tuple(out.shape)} cannot take "
                         f"rows [{seg_lo}, {seg_lo + n}) of width {d}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"segment_sum: messages are on {dev}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def segment_sum_csr(messages: torch.Tensor, rowptr: torch.Tensor,
                    perm: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    seg_lo: int = 0) -> torch.Tensor:
    """messages (E, d) fp32/bf16; rowptr (n+1,) int32, non-decreasing
    offsets into ``perm`` (or into ``messages``); perm (E',) int32 rows of
    ``messages``. Writes ``out[seg_lo + i] = Σ_{j ∈ [rowptr[i],
    rowptr[i+1])} messages[perm[j] if perm else j]`` (fp32 sum in increasing
    j, rounded once) and returns ``out``; with ``out`` None, a new (n, d)
    tensor (``seg_lo`` must then be 0). The offsets are trusted: reading
    them to check would wait for the device."""
    if rowptr.dim() != 1 or rowptr.numel() < 1:
        raise ValueError(f"segment_sum_csr: rowptr must be (n+1,), got "
                         f"{tuple(rowptr.shape)}")
    n = rowptr.numel() - 1
    if out is None:
        if seg_lo:
            raise ValueError("segment_sum_csr: seg_lo needs an out tensor")
        out = torch.empty((n, messages.shape[1]), dtype=messages.dtype,
                          device=messages.device)
    if messages.device.type == "cpu":
        out[seg_lo:seg_lo + n] = segment_sum_csr_ref(messages, rowptr, perm)
        return out
    if messages.device.type != "cuda":
        raise ValueError(f"segment_sum runs on CUDA or CPU tensors, got "
                         f"{messages.device}")
    _check(messages, rowptr, perm, out, seg_lo)
    if n == 0:
        return out
    d = messages.shape[1]
    es = messages.element_size()
    dst = out.data_ptr() + seg_lo * d * es
    vec = _vector_width(d, es, messages.data_ptr(), dst)
    stream = torch.cuda.current_stream(messages.device).cuda_stream
    err = _lib()(messages.data_ptr(), rowptr.data_ptr(),
                 None if perm is None else perm.data_ptr(), dst, n, d,
                 int(messages.dtype == torch.bfloat16), vec, stream)
    if err:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                           f"error {err}")
    segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0


def segment_sum(messages: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """messages (E, d) -> (n_segments, d) in the messages' dtype; ids < 0
    or >= n_segments drop (the reference's ``segment_sum_mm``)."""
    if messages.device.type == "cpu":
        return segment_sum_ref(messages, seg_ids, n_segments)
    if seg_ids.device != messages.device or seg_ids.shape != messages.shape[:1]:
        raise ValueError(f"segment_sum: seg_ids {tuple(seg_ids.shape)} on "
                         f"{seg_ids.device} for messages "
                         f"{tuple(messages.shape)} on {messages.device}")
    if messages.shape[0] >= _INT32_LIMIT:
        raise ValueError(f"segment_sum: E={messages.shape[0]} exceeds the "
                         f"kernel's int32 offsets (< {_INT32_LIMIT})")
    rowptr, perm = csr_from_ids(seg_ids, n_segments)
    return segment_sum_csr(messages, rowptr, perm)
