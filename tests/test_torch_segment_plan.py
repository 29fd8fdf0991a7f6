"""The summing kernel's launch plan (``ops.sum_plan``, ``ops.summing_plan``)
on the CPU: the routes of the in-place kernel in their write-only mode,
with the summing mode's own group rule.

- The plan pinned at the main paths' shapes (``PERF.md`` §6), as
  ``test_acc_plan_at_the_main_paths`` pins the in-place plan.
- Every plan is one that the C entry ``segment_sum_csr`` takes (its checks
  and its instances, written out below), over the widths of every route,
  fp32 and bf16, aligned and not.
- A call's plan reads the pointer of its output's first row.
- On the CPU the summing entry still runs the plain version and launches
  nothing, at every route's width.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref

# 256-byte aligned pointers (the caching allocator's), as the in-place
# plan's tests take them
_ALIGNED = (1 << 20, 1 << 21)


def _entry_takes(plan, d, elem_size, ptrs) -> bool:
    """``segment_sum_csr``'s checks of a plan (csrc/segment_reduce.cu,
    ``run``) and its instances (``dispatch``: NC vectors a lane at most
    4 / (a vector's registers))."""
    vbytes = plan.vec * elem_size
    if plan.vec < 1 or d % plan.vec or plan.group < 1 or plan.grid < 1:
        return False
    if plan.grid > ops._ACC_BLOCKS_CAP or plan.vec * elem_size > 16:
        return False
    if not all(p % vbytes == 0 for p in ptrs):
        return False
    n_vec = d // plan.vec
    if plan.route == "team":
        team = n_vec
        return team <= 32 and plan.group % (32 // team) == 0
    if not (plan.group <= 31 and 1 <= plan.slices <= n_vec):
        return False
    width = -(-n_vec // plan.slices) * plan.vec
    if width != plan.width or (plan.slices - 1) * width >= d:
        return False
    regs = max(1, vbytes // 4)
    nc = -(-(width // plan.vec) // 32)
    return nc <= (4 // regs if vbytes > 4 else 4)


@pytest.mark.parametrize("shape,want", [
    ((2_449_029, 61_859_140, 68, 4), ("medium", 1, 1, 68, 4)),   # EGNN layer
    ((36_709, 928_821, 289, 4), ("wide", 1, 4, 73, 1)),          # NequIP
    ((42_999, 42_790, 6_272, 4), ("wide", 8, 49, 128, 4)),       # Equiformer
    ((10_556, 41_008, 128, 4), ("medium", 2, 1, 128, 4)),        # DimeNet
    ((65_536, 1_341_140, 10, 4), ("team", 6, 1, 10, 2)),         # EmbeddingBag
    ((4_160, 1_048_576, 384, 4), ("wide", 1, 3, 128, 4)),        # k-means runs
    ((64, 4_160, 384, 4), ("wide", 1, 3, 128, 4)),               # its clusters
    ((131_072, 1_048_488, 1, 4), ("team", 32, 1, 1, 1)),         # hop degrees
])
def test_sum_plan_at_the_main_paths(shape, want):
    """The route, group, slices, slice width and vector the summing kernel
    runs at each main path's shape, with 16-byte aligned pointers; the
    grid covers the warps in blocks of 8."""
    plan = ops.sum_plan(*shape, _ALIGNED)
    assert (plan.route, plan.group, plan.slices, plan.width, plan.vec) == want
    assert plan.grid == -(-plan.warps // 8)
    assert _entry_takes(plan, shape[2], shape[3], _ALIGNED)


@pytest.mark.parametrize("n_seg,n_entries,slices,want", [
    (10_556, 41_008, 1, 2),          # DimeNet: ~5k warps, not ~1.7k
    (2_449_029, 61_859_140, 1, 1),   # EGNN: ~25 entries a segment
    (42_999, 42_790, 49, 8),         # Equiformer-v2: 49 slices a group
    (300_000, 300_000, 1, 8),        # one entry a segment, many segments
    (20_000, 20_000, 1, 5),          # ... fewer: at least 4,096 warps
    (10, 0, 1, 31),                  # empty segments only
    (0, 5, 1, 1)])
def test_sum_group_size(n_seg, n_entries, slices, want):
    """About ``SUM_GROUP_ENTRIES`` (8) entries a warp, but at least
    ``SUM_MIN_WARPS`` (groups x slices) where the segments allow; the
    in-place rule packs DimeNet's call onto 6 segments a warp."""
    assert ops.sum_group_size(n_seg, n_entries, slices) == want
    assert ops.group_size(10_556, 41_008) == 6


@pytest.mark.parametrize("d", [1, 2, 10, 16, 17, 64, 67, 68, 128, 255, 256,
                               257, 289, 291, 384, 3_072, 6_272, 6_275])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_sum_plan_is_one_the_kernel_takes(d, elem_size, aligned):
    """Every summing plan meets the C entry's terms (vector, teams, slices,
    group, grid) and takes the in-place plan's route, slices and vector
    for the same row; its group is ``sum_group_size``'s, rounded up to
    whole teams on the team route."""
    ptrs = _ALIGNED if aligned else (_ALIGNED[0], _ALIGNED[1] + elem_size)
    for n_seg, n_entries in ((100_000, 130_000), (700, 50_000), (5, 5),
                             (3_000_000, 3_000_000), (40, 0)):
        plan = ops.sum_plan(n_seg, n_entries, d, elem_size, ptrs)
        assert _entry_takes(plan, d, elem_size, ptrs), plan
        if not aligned:
            assert plan.vec == 1
        acc = ops.acc_plan(n_seg, n_entries, d, elem_size, ptrs)
        assert (plan.route, plan.slices, plan.width, plan.vec) == (
            acc.route, acc.slices, acc.width, acc.vec)
        g = ops.sum_group_size(n_seg, n_entries, plan.slices)
        if plan.route == "team":
            teams = 32 // (d // plan.vec)
            assert plan.group == -(-g // teams) * teams
        else:
            assert plan.group == g
        assert plan.warps == -(-n_seg // plan.group) * plan.slices


def test_summing_plan_reads_the_first_output_row():
    """``summing_plan`` (the plan a call launches) takes the pointers of
    the messages and of row ``seg_lo`` of ``out``: a row is a whole
    number of vectors, so ``seg_lo`` keeps the vector; an output one
    element off 16 bytes takes one-element loads, and so do messages."""
    rowptr = torch.zeros(9, dtype=torch.int32)
    base = torch.zeros(12 * 20 + 8)
    start = (-base.data_ptr() % 16) // 4
    for d, vec in ((12, 4), (10, 2), (289, 1)):
        msg = torch.zeros((64, d))
        out = base[start:start + d * 20].view(20, d) if d < 20 else (
            torch.zeros((20, d)))
        assert out.data_ptr() % 16 == 0 and msg.data_ptr() % 16 == 0
        assert ops.summing_plan(msg, rowptr, None, out).vec == vec
        assert ops.summing_plan(msg, rowptr, None, out, seg_lo=3).vec == vec
    msg = torch.zeros((64, 12))
    off = base[start + 1:start + 1 + 12 * 20].view(20, 12)
    assert ops.summing_plan(msg, rowptr, None, off).vec == 1
    odd = base[start + 1:start + 1 + 12 * 20].view(20, 12)
    aligned = base[start:start + 12 * 20].view(20, 12)
    assert ops.summing_plan(odd, rowptr, None, aligned).vec == 1


@pytest.mark.parametrize("d", [1, 10, 68, 289, 384])
@pytest.mark.parametrize("with_perm", [False, True])
def test_cpu_summing_runs_the_plain_version_at_every_route(d, with_perm):
    """On CPU tensors ``segment_sum_csr`` writes the plain version's rows
    (bit for bit) at ``seg_lo`` and launches nothing, at the widths of
    every route."""
    rng = np.random.default_rng(d)
    deg = rng.integers(0, 9, 120)
    deg[::7] = 0
    rowptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    e = int(rowptr[-1]) + 3
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    perm = (torch.from_numpy(rng.permutation(e)[:e - 3].astype(np.int32))
            if with_perm else None)
    out = torch.full((130, d), float("nan"))
    before = ops.segment_sum_csr.launches
    got = ops.segment_sum_csr(msg, rowptr, perm, out=out, seg_lo=4)
    assert ops.segment_sum_csr.launches == before
    assert torch.equal(got[4:124], segment_sum_csr_ref(msg, rowptr, perm))
    assert bool(got[:4].isnan().all()) and bool(got[124:].isnan().all())
