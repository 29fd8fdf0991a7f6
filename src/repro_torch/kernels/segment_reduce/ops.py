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
- ``segment_sum_csr_accumulate(messages, rowptr, perm=None, *, out,
  rows=None, seg_lo=0)`` adds each segment's sum in place into its row of
  ``out`` (``rows[i]``, or ``seg_lo + i``) and touches no other row: the
  backward role, ``LocalExec``'s gather transposes adding a message
  block's cotangents into one gradient buffer per layer.

``segment_sum_csr.launches`` counts the launches of the summing kernel and
nothing else (both first entry points launch through it);
``segment_sum_csr_accumulate.launches`` counts the in-place kernel's. Each
count is bumped under a lock, so it stays exact when several threads
launch (the shards of ``sharding.collectives.spmd``, autograd's device
threads), and each launch goes onto the current stream of the messages'
device with that device made current, whatever device the calling thread
has current.

On meta tensors (the dry run's traces) each entry point runs the CUDA
route's checks and allocates its outputs, and computes nothing. Every
route opens the dry-run counter's kernel region (``roofline.trace``),
which counts a call by the formula of the kernel's bound: one fp32 add an
entry (and, in place, one a row), each entry, index and touched row read
once and each output row written once.

Both are differentiable (``_SegmentSumCSR``, on either device) when the
messages need a gradient: the backward is the transpose of the sum, a
gather of each message's cotangent row by its segment, 0 for a message no
segment reads (the reference's drop rule). Under grad, ``out=`` is refused
(a raw-pointer write into a caller's buffer carries no graph): the caller
takes each call's own (n, d) result and assembles them.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce.ref import (
    csr_from_ids, segment_sum_csr_accumulate_ref, segment_sum_csr_ref)
from repro_torch.roofline import trace

_SRC = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_ACC_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _P]
_DTYPES = (torch.float32, torch.bfloat16)
# the two launch counts' lock (a leaf: nothing else is taken under it)
_COUNT_LOCK = threading.Lock()
_INT32_LIMIT = 2 ** 31 - 2 ** 20     # rows, segments and entries (int32)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point; builds the library on first use."""
    fn = _build.load(_SRC).segment_sum_csr
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _acc_lib():
    """The in-place kernel's C entry point (the same library)."""
    fn = _build.load(_SRC).segment_sum_csr_accumulate
    fn.argtypes = _ACC_ARGTYPES
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


def _entries(messages, rowptr, perm) -> int:
    """The entries a call reads: its data's, or on meta tensors (no data)
    every listed one, the worst case."""
    if messages.device.type == "meta":
        trace.assume("segment kernels on meta tensors: every listed entry "
                     "read (the worst case)")
        return perm.numel() if perm is not None else messages.shape[0]
    return int(rowptr[-1]) - int(rowptr[0]) if rowptr.numel() else 0


def _sum_work(messages, rowptr, perm):
    """(flops, class, bytes) of one summing call: each entry (and its
    index) read once, each segment's row written once, rowptr read."""
    n, d, es = rowptr.numel() - 1, messages.shape[1], messages.element_size()
    e = _entries(messages, rowptr, perm)
    nbytes = (e * d * es + n * d * es + (n + 1) * 4
              + (0 if perm is None else e * 4))
    return float(e * d), "fp32", nbytes


def _acc_work(messages, rowptr, perm, rows, out):
    """(flops, class, bytes) of one in-place call: each entry, index and
    listed row read once, each touched row of ``out`` read and written."""
    r, d = rowptr.numel() - 1, messages.shape[1]
    e = _entries(messages, rowptr, perm)
    nbytes = (e * d * messages.element_size()
              + (0 if perm is None else e * 4) + (r + 1) * 4
              + (0 if rows is None else r * 4)
              + 2 * r * d * out.element_size())
    return float(e * d + r * d), "fp32", nbytes


def csr_transpose(grad: torch.Tensor, rowptr: torch.Tensor,
                  perm: Optional[torch.Tensor], n_messages: int
                  ) -> torch.Tensor:
    """The transpose of ``segment_sum_csr``: (n, d) cotangents of the sums
    -> (n_messages, d), message ``perm[j]`` (or ``j``) getting the row of
    the segment whose range holds position ``j``, and 0 where no range
    does. ``perm`` must name each message at most once (``csr_from_ids``'s
    does). Gathers only, so it has the same bits on every run."""
    n = rowptr.numel() - 1
    n_pos = n_messages if perm is None else perm.numel()
    if n == 0:
        rows = grad.new_zeros((n_pos, grad.shape[1]))
    else:
        pos = torch.arange(n_pos, device=grad.device)
        seg = torch.searchsorted(rowptr.to(torch.int64), pos, right=True) - 1
        ok = (seg >= 0) & (seg < n)
        rows = torch.where(ok[:, None],
                           grad.index_select(0, seg.clamp(0, n - 1)), 0.0)
    if perm is None:
        return rows
    full = grad.new_zeros((n_messages, grad.shape[1]))
    return full.index_copy_(0, perm.to(torch.int64), rows)


class _SegmentSumCSR(torch.autograd.Function):
    """``segment_sum_csr`` with a gradient for the messages."""

    @staticmethod
    def forward(ctx, messages, rowptr, perm):
        ctx.save_for_backward(rowptr, perm)
        ctx.n_messages = messages.shape[0]
        return _segment_sum_csr(messages, rowptr, perm, None, 0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        rowptr, perm = ctx.saved_tensors
        return csr_transpose(grad, rowptr, perm, ctx.n_messages), None, None


def _needs_grad(messages: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and messages.requires_grad


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
    them to check would wait for the device. Messages that need a gradient
    take the differentiable route, which refuses ``out``."""
    if rowptr.dim() != 1 or rowptr.numel() < 1:
        raise ValueError(f"segment_sum_csr: rowptr must be (n+1,), got "
                         f"{tuple(rowptr.shape)}")
    if _needs_grad(messages):
        if out is not None or seg_lo:
            raise ValueError("segment_sum_csr: out=/seg_lo= take no gradient; "
                             "under grad call it without out and assemble "
                             "the results")
        return _SegmentSumCSR.apply(messages, rowptr, perm)
    return _segment_sum_csr(messages, rowptr, perm, out, seg_lo)


def _segment_sum_csr(messages, rowptr, perm, out, seg_lo) -> torch.Tensor:
    n = rowptr.numel() - 1
    if out is None:
        if seg_lo:
            raise ValueError("segment_sum_csr: seg_lo needs an out tensor")
        out = torch.empty((n, messages.shape[1]), dtype=messages.dtype,
                          device=messages.device)
    with trace.kernel("segment_sum",
                      lambda: _sum_work(messages, rowptr, perm)):
        return _segment_sum_route(messages, rowptr, perm, out, seg_lo, n)


def _segment_sum_route(messages, rowptr, perm, out, seg_lo, n):
    if messages.device.type == "cpu":
        out[seg_lo:seg_lo + n] = segment_sum_csr_ref(messages, rowptr, perm)
        return out
    if messages.device.type not in ("cuda", "meta"):
        raise ValueError(f"segment_sum runs on CUDA or CPU tensors, got "
                         f"{messages.device}")
    _check(messages, rowptr, perm, out, seg_lo)
    if n == 0 or messages.device.type == "meta":
        return out
    d = messages.shape[1]
    plan = summing_plan(messages, rowptr, perm, out, seg_lo)
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        err = _lib()(messages.data_ptr(), rowptr.data_ptr(),
                     None if perm is None else perm.data_ptr(),
                     out.data_ptr() + seg_lo * d * messages.element_size(),
                     n, d, int(messages.dtype == torch.bfloat16),
                     int(plan.route != "team"), plan.vec, plan.group,
                     plan.slices, plan.grid, stream)
    if err:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0


def segment_sum(messages: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """messages (E, d) -> (n_segments, d) in the messages' dtype; ids < 0
    or >= n_segments drop (the reference's ``segment_sum_mm``)."""
    if messages.device.type == "cpu":
        return segment_sum_csr(messages, *csr_from_ids(seg_ids, n_segments))
    if seg_ids.device != messages.device or seg_ids.shape != messages.shape[:1]:
        raise ValueError(f"segment_sum: seg_ids {tuple(seg_ids.shape)} on "
                         f"{seg_ids.device} for messages "
                         f"{tuple(messages.shape)} on {messages.device}")
    if messages.shape[0] >= _INT32_LIMIT:
        raise ValueError(f"segment_sum: E={messages.shape[0]} exceeds the "
                         f"kernel's int32 offsets (< {_INT32_LIMIT})")
    rowptr, perm = csr_from_ids(seg_ids, n_segments)
    return segment_sum_csr(messages, rowptr, perm)


# the in-place kernel's warps at least, where the segments allow: 16 a
# streaming multiprocessor of the H100's 132
_ACC_MIN_WARPS = 2048
# the summing kernel's group rule (csrc/segment_reduce.cu's note has the
# sweep behind it): about SUM_GROUP_ENTRIES entries a warp, not 32 as in
# place (Equiformer-v2's mostly empty segments 0.734 ms at 8 a warp, 0.755
# at 31; DimeNet's gathered ~4-entry segments 0.0178 at 2 a warp, 0.0185
# at 1), but at least SUM_MIN_WARPS (groups x slices) where the segments
# allow
SUM_GROUP_ENTRIES = 8
SUM_MIN_WARPS = 4096
# both kernels' routes (csrc/segment_reduce.cu, whose note has the
# measurements behind each number): rows of at most ACC_TEAM_BYTES take
# the team route; a row whose vectors fit 32 lanes at ACC_LANE_REGS 32-bit
# registers a lane is one slice (medium); a wider row is cut into slices
# of ACC_SLICE_REGS registers a lane, or one vector where a vector is
# wider (wide); 8 warps a block, at most 2^20 blocks
ACC_TEAM_BYTES = 64
ACC_LANE_REGS = 4
ACC_SLICE_REGS = 3
_ACC_BLOCK_WARPS = 8
_ACC_BLOCKS_CAP = 1 << 20


def _entry_group(n_seg: int, n_entries: int, entries: int = 32) -> int:
    """About ``entries`` entries a warp (32: one coalesced ``perm``
    load), 1 to 31 segments."""
    return max(1, min(31, int(entries * n_seg / max(n_entries, 1))))


def group_size(n_seg: int, n_entries: int) -> int:
    """Segments per warp of the in-place kernel: about 32 entries a warp,
    but not so many that fewer than ``_ACC_MIN_WARPS`` warps share the
    entries (a small launch, such as an LM micro-batch's ~4,050 tokens,
    would otherwise run on ~130 warps). It changes no bit."""
    g = _entry_group(n_seg, n_entries)
    if not n_entries:
        return g
    return min(g, max(1, -(-n_seg // _ACC_MIN_WARPS)))


def sum_group_size(n_seg: int, n_entries: int, slices: int = 1) -> int:
    """Segments per warp of the summing kernel: about
    ``SUM_GROUP_ENTRIES`` entries a warp, but not so many that fewer than
    ``SUM_MIN_WARPS`` warps (groups x column slices) share the entries. It
    changes no bit."""
    g = _entry_group(n_seg, n_entries, SUM_GROUP_ENTRIES)
    if not n_entries:
        return g
    return min(g, max(1, -(-n_seg * slices // SUM_MIN_WARPS)))


class AccPlan(NamedTuple):
    """One launch of either kernel: ``route`` "team" (a team of ``d /
    vec`` lanes a segment), "medium" (a warp a group of segments, the
    whole row) or "wide" (a warp a (group, column slice)); ``group``
    segments a warp; ``slices`` column slices of ``width`` columns (the
    last may be narrower); ``vec`` elements a lane load; ``warps`` the
    work items; ``grid`` the blocks launched (a grid-stride loop covers
    warps past the cap)."""
    route: str
    group: int
    slices: int
    width: int
    vec: int
    warps: int
    grid: int


def _route(d: int, elem_size: int, ptrs) -> tuple:
    """(route, slices, width, vec) of a row of ``d`` elements of
    ``elem_size`` bytes: the vector is the widest of 16/8/4/2 bytes that
    divides a row and aligns ``ptrs`` (``_vector_width``). Rows of
    ``ACC_TEAM_BYTES`` or less go to the team route; wider rows to the row
    kernel, in one slice where 32 lanes hold the row within
    ``ACC_LANE_REGS`` registers each (medium), else in column slices of
    balanced widths, each within ``ACC_SLICE_REGS`` registers (or one
    vector) a lane (wide)."""
    vec = _vector_width(d, elem_size, *ptrs)
    n_vec = d // vec
    regs = max(1, vec * elem_size // 4)          # a vector's registers
    if d * elem_size <= ACC_TEAM_BYTES:
        return "team", 1, d, vec
    if -(-n_vec // 32) * regs <= ACC_LANE_REGS:
        return "medium", 1, d, vec
    lane_vecs = max(1, ACC_SLICE_REGS // regs)
    per_slice = -(-n_vec // -(-n_vec // (32 * lane_vecs)))
    return "wide", -(-n_vec // per_slice), per_slice * vec, vec


def _launch(n_seg: int, d: int, route: str, g: int, slices: int, width: int,
            vec: int) -> AccPlan:
    """The plan of ``route`` at ``g`` segments a warp (rounded up to whole
    teams on the team route), its warps and grid."""
    if route == "team":
        teams = 32 // (d // vec)
        g = -(-g // teams) * teams
    warps = -(-n_seg // g) * slices
    grid = min(-(-warps // _ACC_BLOCK_WARPS), _ACC_BLOCKS_CAP)
    return AccPlan(route, g, slices, width, vec, warps, grid)


def acc_plan(n_seg: int, n_entries: int, d: int, elem_size: int,
             ptrs=()) -> AccPlan:
    """The in-place kernel's launch plan for ``n_seg`` segments over
    ``n_entries`` entries of rows of ``d`` elements of ``elem_size``
    bytes, the messages' and the output's base pointers in ``ptrs``:
    ``_route``'s route at ``group_size`` segments a warp. No plan changes
    a bit."""
    route, slices, width, vec = _route(d, elem_size, ptrs)
    return _launch(n_seg, d, route, group_size(n_seg, n_entries), slices,
                   width, vec)


def sum_plan(n_seg: int, n_entries: int, d: int, elem_size: int,
             ptrs=()) -> AccPlan:
    """The summing kernel's launch plan (the in-place kernel's routes,
    writing each row once and reading none): ``_route``'s route at
    ``sum_group_size`` segments a warp. No plan changes a bit."""
    route, slices, width, vec = _route(d, elem_size, ptrs)
    return _launch(n_seg, d, route, sum_group_size(n_seg, n_entries, slices),
                   slices, width, vec)


def _n_entries(messages, perm) -> int:
    return messages.shape[0] if perm is None else perm.numel()


def summing_plan(messages: torch.Tensor, rowptr: torch.Tensor,
                 perm: Optional[torch.Tensor], out: torch.Tensor,
                 seg_lo: int = 0) -> AccPlan:
    """The plan ``segment_sum_csr`` launches for these arguments (a CUDA
    call's; on the CPU the same pointers' plan): the output's pointer is
    that of row ``seg_lo``."""
    es = messages.element_size()
    return sum_plan(rowptr.numel() - 1, _n_entries(messages, perm),
                    messages.shape[1], es,
                    (messages.data_ptr(),
                     out.data_ptr() + seg_lo * messages.shape[1] * es))


def accumulate_plan(messages: torch.Tensor, rowptr: torch.Tensor,
                    perm: Optional[torch.Tensor], out: torch.Tensor
                    ) -> AccPlan:
    """The plan ``segment_sum_csr_accumulate`` launches for these
    arguments (a CUDA call's; on the CPU the same pointers' plan)."""
    return acc_plan(rowptr.numel() - 1, _n_entries(messages, perm),
                    messages.shape[1], messages.element_size(),
                    (messages.data_ptr(), out.data_ptr()))


def segment_sum_csr_accumulate(messages: torch.Tensor, rowptr: torch.Tensor,
                               perm: Optional[torch.Tensor] = None, *,
                               out: torch.Tensor,
                               rows: Optional[torch.Tensor] = None,
                               seg_lo: int = 0) -> torch.Tensor:
    """In place: ``out[r_i] = out[r_i] + Σ_{j ∈ [rowptr[i], rowptr[i+1])}
    messages[perm[j] if perm else j]`` for each segment i (the sum in fp32
    from 0 in increasing j, added once in fp32 and rounded once to
    ``out``'s dtype), where ``r_i = rows[i]`` (int32, distinct) or
    ``seg_lo + i``; returns ``out``. Only the listed rows are read or
    written, each column of a row by one lane: no atomics, the same bits
    on every run and for every plan (``acc_plan``, ``group_size``). The
    offsets and the rows are trusted: reading them to check would wait
    for the device. It takes no gradient (it is a backward's
    accumulation)."""
    if rowptr.dim() != 1 or rowptr.numel() < 1:
        raise ValueError(f"segment_sum_csr_accumulate: rowptr must be "
                         f"(n+1,), got {tuple(rowptr.shape)}")
    n = rowptr.numel() - 1
    if _needs_grad(messages):
        raise ValueError("segment_sum_csr_accumulate takes no gradient")
    if rows is not None and (rows.dim() != 1 or rows.numel() != n):
        raise ValueError(f"segment_sum_csr_accumulate: rows must be ({n},), "
                         f"got {tuple(rows.shape)}")
    if rows is not None and seg_lo:
        raise ValueError("segment_sum_csr_accumulate: rows= and seg_lo= "
                         "exclude each other")
    with trace.kernel("segment_sum_csr_accumulate",
                      lambda: _acc_work(messages, rowptr, perm, rows, out)):
        return _accumulate_route(messages, rowptr, perm, out, rows, seg_lo, n)


def _accumulate_route(messages, rowptr, perm, out, rows, seg_lo, n):
    if messages.device.type == "cpu":
        return segment_sum_csr_accumulate_ref(messages, rowptr, perm, out=out,
                                              rows=rows, seg_lo=seg_lo)
    if messages.device.type not in ("cuda", "meta"):
        raise ValueError(f"segment_sum runs on CUDA or CPU tensors, got "
                         f"{messages.device}")
    _check(messages, rowptr, perm, out, seg_lo)
    if rows is not None and (rows.device != messages.device
                             or rows.dtype != torch.int32
                             or not rows.is_contiguous()):
        raise ValueError("segment_sum_csr_accumulate: rows must be "
                         "contiguous int32 on the messages' device")
    if n == 0 or messages.device.type == "meta":
        return out
    plan = accumulate_plan(messages, rowptr, perm, out)
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        err = _acc_lib()(messages.data_ptr(), rowptr.data_ptr(),
                         None if perm is None else perm.data_ptr(),
                         None if rows is None else rows.data_ptr(),
                         out.data_ptr(), n, messages.shape[1], seg_lo,
                         int(messages.dtype == torch.bfloat16),
                         int(plan.route != "team"), plan.vec, plan.group,
                         plan.slices, plan.grid, stream)
    if err:
        raise RuntimeError(f"segment_sum_csr_accumulate: kernel launch failed "
                           f"with CUDA error {err}")
    with _COUNT_LOCK:
        segment_sum_csr_accumulate.launches += 1
    return out


segment_sum_csr_accumulate.launches = 0
