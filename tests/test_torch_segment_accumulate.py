"""The in-place segment sum (``ops.segment_sum_csr_accumulate``, the
backward role of the segment-sum kernel) and ``LocalExec``'s gradient path
built on it, on the CPU.

- The plain version against a float64 ``index_add_`` oracle, and bit for
  bit against a loop written in the documented order (fp32 sum from 0, one
  add per entry in increasing j, added to the row once, rounded once).
- The two forms the gather transposes use: a block's destination range
  (its ``rowptr`` slice, no perm) and its compacted distinct sources
  (``csr_by_row``); an empty block; the last block's padding rows.
- One ``push`` backward over several blocks, profiled with
  ``record_shapes``: one zero-filled (N, Dp) buffer a call and no (N, Dp)
  add, where autograd's own transpose adds one a block; its gradients
  equal autograd's own transpose (``index_add_``, which on the CPU adds in
  index order) bit for bit, at EGNN's full width.

Tolerance against the float64 oracle: 1e-5 relative to max(1, |want|),
fp32 sums of a few O(1) terms in another order.
"""
import pytest

pytest.importorskip("torch")

from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import (
    segment_sum_csr_accumulate_ref)
from repro_torch.models.gnn import common as gc
from repro_torch.models.gnn import driver as gd


def _csr_case(seed, n_seg, n_msg, d, with_perm, dtype=torch.float32):
    """Segments of 0-6 entries over ``n_msg`` messages (a perm, or the
    first ``rowptr[-1]`` rows in order)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, n_seg)
    deg[::5] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    assert rowptr[-1] <= n_msg
    perm = (rng.permutation(n_msg)[:rowptr[-1]].astype(np.int32)
            if with_perm else None)
    msg = torch.from_numpy(rng.normal(size=(n_msg, d)).astype(np.float32))
    return (msg.to(dtype), torch.from_numpy(rowptr),
            None if perm is None else torch.from_numpy(perm), rng)


def _loop(msg, rowptr, perm, out, rows):
    """The contract as a loop: one row at a time, one add per entry."""
    out = out.clone()
    for i in range(rowptr.numel() - 1):
        acc = torch.zeros(msg.shape[1], dtype=torch.float32)
        for j in range(int(rowptr[i]), int(rowptr[i + 1])):
            acc = acc + msg[int(perm[j]) if perm is not None else j].float()
        r = int(rows[i])
        out[r] = (out[r].float() + acc).to(out.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_perm", [False, True])
@pytest.mark.parametrize("listed", [False, True])
def test_accumulate_is_the_documented_loop(listed, with_perm, dtype):
    """Bit for bit against the loop, into rows listed (``rows``, shuffled)
    or a range (``seg_lo``); the other rows keep their bits."""
    msg, rowptr, perm, rng = _csr_case(1, 40, 300, 67, with_perm, dtype)
    out0 = torch.from_numpy(rng.normal(size=(90, 67)).astype(np.float32)
                            ).to(dtype)
    if listed:
        rows = torch.from_numpy(rng.permutation(90)[:40].astype(np.int32))
        got = ops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                             out=out0.clone(), rows=rows)
    else:
        rows = torch.arange(17, 57, dtype=torch.int32)
        got = ops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                             out=out0.clone(), seg_lo=17)
    want = _loop(msg, rowptr, perm, out0, rows)
    assert got.dtype == dtype and torch.equal(got, want)
    untouched = torch.ones(90, dtype=torch.bool)
    untouched[rows.long()] = False
    assert torch.equal(got[untouched], out0[untouched])


@pytest.mark.parametrize("with_perm", [False, True])
def test_accumulate_matches_float64_index_add(with_perm):
    msg, rowptr, perm, rng = _csr_case(2, 200, 1200, 5, with_perm)
    rows = torch.from_numpy(rng.permutation(500)[:200].astype(np.int32))
    out0 = torch.from_numpy(rng.normal(size=(500, 5)).astype(np.float32))
    got = ops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                         out=out0.clone(), rows=rows)
    pos = torch.arange(int(rowptr[-1]))
    seg = torch.searchsorted(rowptr.long(), pos, right=True) - 1
    src = pos if perm is None else perm.long()
    want = out0.double().index_add_(0, rows.long()[seg], msg.double()[src])
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.double(), want, rtol=0, atol=tol)


def test_accumulate_wrapper_refuses():
    """A gradient, rows of the wrong length, and rows with ``seg_lo``."""
    msg, rowptr, perm, _ = _csr_case(3, 10, 60, 4, True)
    out = torch.zeros((20, 4))
    with pytest.raises(ValueError, match="no gradient"):
        ops.segment_sum_csr_accumulate(msg.requires_grad_(True), rowptr,
                                       perm, out=out)
    msg = msg.detach()
    with pytest.raises(ValueError, match="rows"):
        ops.segment_sum_csr_accumulate(msg, rowptr, perm, out=out,
                                       rows=torch.arange(9, dtype=torch.int32))
    with pytest.raises(ValueError, match="exclude"):
        ops.segment_sum_csr_accumulate(msg, rowptr, perm, out=out, seg_lo=1,
                                       rows=torch.arange(10, dtype=torch.int32))
    assert torch.equal(segment_sum_csr_accumulate_ref(
        msg, rowptr, perm, out=out.clone(), seg_lo=3),
        ops.segment_sum_csr_accumulate(msg, rowptr, perm, out=out.clone(),
                                       seg_lo=3))


@pytest.mark.parametrize("n_seg,n_entries,want", [
    (853_000, 1 << 20, 26), (41_500, 1 << 20, 1), (10, 0, 31), (0, 5, 1)])
def test_group_size(n_seg, n_entries, want):
    """About 32 entries a warp: a block's sources, its destinations, a
    range of empty segments, nothing."""
    assert ops.group_size(n_seg, n_entries) == want


# 256-byte aligned pointers (the caching allocator's), and an output whose
# base is one element off 16 bytes
_ALIGNED = (1 << 20, 1 << 21)


@pytest.mark.parametrize("shape,want", [
    ((852_959, 1 << 20, 67, 4), ("medium", 26, 1, 67, 1)),     # EGNN source
    ((41_464, 1 << 20, 67, 4), ("medium", 1, 1, 67, 1)),       # destination
    ((248_606, 524_288, 291, 4), ("wide", 15, 4, 73, 1)),      # NequIP
    ((65_536, 65_536, 6_275, 4), ("wide", 31, 66, 96, 1)),     # Equiformer-v2
    ((4_056, 4_096, 3_072, 2), ("wide", 2, 12, 256, 8)),       # LM token
    ((10_312, 41_008, 128, 4), ("medium", 6, 1, 128, 4)),      # DimeNet m[ts]
    ((1_874_493, 2_555_904, 10, 4), ("team", 24, 1, 10, 2)),   # xDeepFM tables
    ((1_874_493, 2_555_904, 1, 4), ("team", 32, 1, 1, 1)),     # linear_w
])
def test_acc_plan_at_the_main_paths(shape, want):
    """The route, group, slices, slice width and vector the in-place kernel
    runs at each main path's shape (``PERF.md`` §6), with 16-byte aligned
    pointers; the grid covers the warps in blocks of 8."""
    plan = ops.acc_plan(*shape, _ALIGNED)
    assert (plan.route, plan.group, plan.slices, plan.width, plan.vec) == want
    assert plan.grid == -(-plan.warps // 8)


@pytest.mark.parametrize("d", [1, 2, 10, 16, 17, 64, 128, 255, 256, 257, 291,
                               3_072, 6_275])
@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_acc_plan_is_one_the_kernel_takes(d, elem_size, aligned):
    """Every plan meets the C entry's terms: the vector divides the row and
    aligns both pointers; rows of 64 bytes or less run in teams of d / vec
    lanes, whole teams to a warp; wider rows run at most 31 segments a warp
    in non-empty slices of whole vectors: one slice where 32 lanes hold
    the row within 4 registers each, else as few balanced slices as hold
    it within 3 registers, or one vector, a lane."""
    ptrs = _ALIGNED if aligned else (_ALIGNED[0], _ALIGNED[1] + elem_size)
    for n_seg, n_entries in ((100_000, 130_000), (700, 50_000), (5, 5)):
        plan = ops.acc_plan(n_seg, n_entries, d, elem_size, ptrs)
        vbytes = plan.vec * elem_size
        assert d % plan.vec == 0 and all(p % vbytes == 0 for p in ptrs)
        assert plan.vec == 1 or vbytes <= 16
        if not aligned:
            assert plan.vec == 1
        if d * elem_size <= ops.ACC_TEAM_BYTES:
            team = d // plan.vec
            assert plan.route == "team" and team <= 32
            assert plan.group % (32 // team) == 0
        else:
            assert plan.route == ("medium" if plan.slices == 1 else "wide")
            assert 1 <= plan.group <= 31
            assert plan.width % plan.vec == 0
            assert (plan.slices - 1) * plan.width < d <= plan.slices * plan.width
            lanes = -(-plan.width // plan.vec)
            regs = max(1, vbytes // 4)
            assert -(-lanes // 32) * regs <= ops.ACC_LANE_REGS
            n_vec = d // plan.vec
            if -(-n_vec // 32) * regs <= ops.ACC_LANE_REGS:
                assert plan.route == "medium"
            else:
                fewest = -(-n_vec // (32 * max(1, ops.ACC_SLICE_REGS // regs)))
                assert plan.width == -(-n_vec // fewest) * plan.vec
        assert plan.warps == -(-n_seg // plan.group) * plan.slices


# ------------------------------------------------------ the transposes' forms
def _exec(n=300, e=1000, block=64, budget=200, seed=3):
    g = gd.make_flat_graph(n, e, 4, seed=seed, device="cpu")
    old = gc.MSG_BLOCK_EDGES
    gc.MSG_BLOCK_EDGES = block
    try:
        return g, gc.LocalExec(g, budget)
    finally:
        gc.MSG_BLOCK_EDGES = old


def _buffer_with(values):
    buf = gc._GradBuffer(values)
    buf.buf = values.clone()
    return buf


@pytest.mark.parametrize("k", [0, 3, 15])
def test_destination_form_adds_the_block_range_only(k):
    """Block k's destination transpose: its edges' cotangents summed by
    destination in edge order (``index_add_`` into zeros, on the CPU) and
    added to the base once; the rows outside ``[dst[a], dst[b-1]]``
    untouched; the padding rows (past the last edge of block 15) in no
    segment."""
    g, ex = _exec()
    assert ex.block == 64 and -(-ex.n_edges // 64) == 16
    a, b = ex._block_edges(k)
    rng = np.random.default_rng(k)
    cot = torch.from_numpy(rng.normal(size=(64, 7)).astype(np.float32))
    cot[b - a:] = 1e30                              # padding: never read
    base = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    buf = _buffer_with(base)
    ex._add_dst(buf, k, cot)
    want = base + torch.zeros_like(base).index_add_(0, ex.dst[a:b].long(),
                                                    cot[:b - a])
    assert torch.equal(buf.buf, want)
    lo, hi = int(ex.dst[a]), int(ex.dst[b - 1]) + 1
    assert torch.equal(buf.buf[:lo], base[:lo])
    assert torch.equal(buf.buf[hi:], base[hi:])


@pytest.mark.parametrize("k", [0, 15])
def test_source_form_is_compacted(k):
    """Block k's source transpose: a CSR over its distinct sources only
    (sorted, stable), its sums those of ``index_add_`` in edge order, added
    to the base once; the padding
    rows (copies of node 0) add nothing to row 0."""
    g, ex = _exec()
    a, b = ex._block_edges(k)
    rowptr, perm, rows = gc.csr_by_row(ex.src[a:b])
    keys = ex.src[a:b]
    uniq = torch.unique(keys)
    assert torch.equal(rows.long(), uniq.long()) and rows.dtype == torch.int32
    assert rowptr.numel() == uniq.numel() + 1 and int(rowptr[-1]) == b - a
    assert torch.equal(perm.long(), torch.sort(keys, stable=True)[1])
    rng = np.random.default_rng(10 + k)
    cot = torch.from_numpy(rng.normal(size=(64, 7)).astype(np.float32))
    cot[b - a:] = 1e30
    base = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    buf = _buffer_with(base)
    ex._add_src(buf, k, cot)
    want = base + torch.zeros_like(base).index_add_(0, keys.long(),
                                                    cot[:b - a])
    assert torch.equal(buf.buf, want)
    missing = torch.ones(300, dtype=torch.bool)
    missing[uniq.long()] = False
    assert torch.equal(buf.buf[missing], base[missing])


def test_empty_block_adds_nothing():
    """A graph whose edges are all masked: one empty block; the payload's
    gradient is zero, and the message function's weights get theirs."""
    g = gd.make_flat_graph(40, 100, 4, seed=5, device="cpu")
    g = g._replace(edge_mask=torch.zeros(100, dtype=torch.bool))
    ex = gc.LocalExec(g, 16)
    assert ex.n_edges == 0
    p = torch.randn(40, 6, requires_grad=True)
    w = torch.randn(12, 3, requires_grad=True)
    out = ex.push(p, lambda s, d: torch.cat([s, d], -1) @ w, 3)
    gp, gw = torch.autograd.grad(out.sum(), (p, w))
    assert not out.any() and not gp.any() and not gw.any()
    assert gp.shape == (40, 6)


# ------------------------------------------------------------ one push's path
def _plain_transposes(monkeypatch):
    """``LocalExec`` with autograd's own gather transposes (``index_add_``
    into a dense (N, Dp) per gather), the route the buffer replaces."""
    monkeypatch.setattr(gc.LocalExec, "_sink",
                        staticmethod(lambda payload: (payload, None)))


def _push_backward_profile(n=300, dp=7):
    g, ex = _exec(n=n)
    p = torch.randn(n, dp, requires_grad=True)
    w = torch.randn(2 * dp, 5)
    out = ex.push(p, lambda s, d: torch.tanh(torch.cat([s, d], -1) @ w), 5)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        torch.autograd.grad(out, p, torch.ones_like(out))
    shaped = Counter(e.name for e in prof.events()
                     if [n, dp] in [list(s) for s in e.input_shapes])
    return -(-ex.n_edges // ex.block), shaped


def test_push_backward_keeps_one_buffer(monkeypatch):
    """Over 16 blocks: one (N, Dp) zero fill and no (N, Dp) add; autograd's
    own transposes add one (N, Dp) gradient a gather."""
    blocks, shaped = _push_backward_profile()
    assert blocks == 16
    adds = shaped["aten::add"] + shaped["aten::add_"]
    assert adds == 0 and shaped["aten::zero_"] == 1, shaped
    _plain_transposes(monkeypatch)
    _, plain = _push_backward_profile()
    assert plain["aten::add"] + plain["aten::add_"] >= blocks, plain


def test_push_grads_equal_autograd_transposes_bitwise(monkeypatch):
    """A full-width EGNN loss over 20 message blocks and 2 chunk budgets:
    every gradient has the bits of autograd's own transposes (on the CPU
    ``index_add_`` adds in index order, the CSR's order)."""
    monkeypatch.setattr(gc, "MSG_BLOCK_EDGES", 256)
    cfg = get_config("egnn")
    g = gd.make_flat_graph(500, 5000, 12, seed=3, device="cpu")
    params = gd.init_model(cfg, 0, 12, device="cpu")

    def grads(budget):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        ex = gc.LocalExec(g, budget)
        assert -(-ex.n_edges // ex.block) == 20
        loss, _ = gd.train_loss(cfg, "full_graph", live,
                                {"graph": g, "exec": ex})
        return torch.autograd.grad(loss, leaves(live))

    got = [grads(b) for b in (700, 10 ** 9)]
    _plain_transposes(monkeypatch)
    want = grads(700)
    for run in got:
        assert all(torch.equal(a, b) for a, b in zip(run, want))
