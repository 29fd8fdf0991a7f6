"""The port's segment sum (plain version, on the CPU) and its segment
primitives against the JAX package's.

On the CPU the port's ``segment_sum`` / ``segment_sum_csr`` wrappers run
their plain versions (``kernels/segment_reduce/ref.py``); the reference runs
its Pallas kernel in interpret mode through ``segment_sum_mm`` (as
``tests/test_kernels.py`` does) and its ``jax.ops`` oracle. The CUDA kernel
itself is held against the plain version by the ``gpu``-marked cases of
``tests/test_torch_kernels_gpu.py``.

Tolerances are the reference test's own: fp32 1e-5 (sums of O(1) terms in
another order), bf16 0.1 (the Pallas kernel accumulates bf16 across edge
blocks in bf16; the port rounds once from fp32).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax.numpy as jnp
import torch

from repro.kernels.segment_reduce import segment_sum_mm
from repro.kernels.segment_reduce.ref import segment_sum_ref as j_ref
from repro.sparse import segment as j_seg
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import (
    csr_from_ids, segment_sum_csr_ref, segment_sum_ref)
from repro_torch.sparse import segment as t_seg

_DT = {"float32": (jnp.float32, torch.float32, 1e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.1)}


def _ids(rng, e, n):
    """Ids in [-1, n) with some >= n, unsorted; segment 0 left empty."""
    seg = rng.integers(-1, n, e)
    seg[seg == 0] = 1
    seg[rng.random(e) < 0.05] = n + 3
    return seg.astype(np.int32)


def _csr_np(seg, n):
    """(rowptr, perm) built with numpy: a stable grouping of the kept ids."""
    keep = np.flatnonzero((seg >= 0) & (seg < n))
    perm = keep[np.argsort(seg[keep], kind="stable")].astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(seg[keep],
                                                        minlength=n))])
    return rowptr.astype(np.int32), perm


@pytest.mark.parametrize("e,d,n", [(512, 16, 64), (3000, 48, 300),
                                   (1024, 128, 512), (600, 1, 80),
                                   (800, 10, 100), (400, 289, 50),
                                   (512, 384, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_matches_reference(e, d, n, dtype):
    jdt, tdt, tol = _DT[dtype]
    rng = np.random.default_rng(e + d)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    seg = _ids(rng, e, n)
    want_k = np.asarray(segment_sum_mm(jnp.asarray(msg).astype(jdt),
                                       jnp.asarray(seg), n), np.float32)
    want_r = np.asarray(j_ref(jnp.asarray(msg).astype(jdt), jnp.asarray(seg),
                              n), np.float32)
    tmsg = torch.from_numpy(msg).to(tdt)
    got = ops.segment_sum(tmsg, torch.from_numpy(seg), n)
    assert got.dtype == tdt and got.shape == (n, d)
    rowptr, perm = _csr_np(seg, n)
    got_csr = ops.segment_sum_csr(tmsg, torch.from_numpy(rowptr),
                                  torch.from_numpy(perm))
    assert torch.equal(got, got_csr)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    assert bool((got[0] == 0).all())                 # the empty segment


def test_csr_grouping_is_stable_and_drops_out_of_range_ids():
    rng = np.random.default_rng(3)
    seg = _ids(rng, 500, 40)
    rowptr, perm = csr_from_ids(torch.from_numpy(seg), 40)
    want_rp, want_perm = _csr_np(seg, 40)
    np.testing.assert_array_equal(rowptr.numpy(), want_rp)
    np.testing.assert_array_equal(perm.numpy()[:want_rp[-1]], want_perm)
    assert rowptr.dtype == perm.dtype == torch.int32


def test_csr_sum_is_a_fixed_order_fp32_sum():
    """Each segment is one fp32 add per entry in increasing j: a loop in
    numpy float32 gives the same bits, with and without a perm, and a
    sorted copy of the messages gives the same bits as the perm."""
    rng = np.random.default_rng(4)
    n, d = 30, 5
    deg = rng.integers(0, 9, n)
    deg[3] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(rowptr[-1])
    msg = (rng.normal(size=(e, d)) * 10.0 ** rng.integers(-3, 4, (e, 1))
           ).astype(np.float32)
    perm = rng.permutation(e).astype(np.int32)
    want = np.zeros((n, d), np.float32)
    for i in range(n):
        for j in range(rowptr[i], rowptr[i + 1]):
            want[i] = want[i] + msg[perm[j]]
    got = segment_sum_csr_ref(torch.from_numpy(msg), torch.from_numpy(rowptr),
                              torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), want)
    grouped = torch.from_numpy(msg[perm])
    np.testing.assert_array_equal(
        segment_sum_csr_ref(grouped, torch.from_numpy(rowptr)).numpy(), want)


def test_csr_writes_into_out_at_seg_lo():
    """Chunks of whole segments written into one output give the bits of
    one call over all segments."""
    rng = np.random.default_rng(5)
    deg = rng.integers(0, 6, 50)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    msg = torch.from_numpy(rng.normal(size=(int(rowptr[-1]), 7))
                           .astype(np.float32))
    whole = ops.segment_sum_csr(msg, torch.from_numpy(rowptr.astype(np.int32)))
    out = torch.full((50, 7), float("nan"))
    for lo, hi in ((0, 13), (13, 14), (14, 50)):
        rp = torch.from_numpy((rowptr[lo:hi + 1] - rowptr[lo]).astype(np.int32))
        ops.segment_sum_csr(msg[rowptr[lo]:rowptr[hi]], rp, out=out, seg_lo=lo)
    assert torch.equal(out, whole)
    with pytest.raises(ValueError):
        ops.segment_sum_csr(msg, torch.zeros(3, dtype=torch.int32), seg_lo=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_edge_cases(dtype):
    """E = 0, every id dropped, N = 1."""
    _, tdt, _ = _DT[dtype]
    empty = ops.segment_sum(torch.zeros((0, 4), dtype=tdt),
                            torch.zeros((0,), dtype=torch.int32), 6)
    assert empty.shape == (6, 4) and empty.dtype == tdt
    assert bool((empty == 0).all())
    msg = torch.ones((10, 3), dtype=tdt)
    dropped = ops.segment_sum(msg, torch.tensor([-1, 5] * 5, dtype=torch.int32),
                              5)
    assert bool((dropped == 0).all())
    one = ops.segment_sum(msg, torch.zeros(10, dtype=torch.int32), 1)
    assert one.shape == (1, 3) and bool((one == 10).all())
    assert ops.segment_sum(msg, torch.zeros(10, dtype=torch.int32),
                           0).shape == (0, 3)


def test_plain_version_is_used_on_cpu_without_launching():
    before = ops.segment_sum_csr.launches
    msg = torch.ones((4, 2))
    out = ops.segment_sum(msg, torch.tensor([0, 1, 1, 9]), 2)
    assert out.tolist() == [[1, 1], [2, 2]]
    assert ops.segment_sum_csr.launches == before


@pytest.mark.parametrize("trailing", [(), (3,), (2, 4)])
def test_segment_primitives_match_reference(trailing):
    rng = np.random.default_rng(len(trailing))
    e, n = 400, 37
    data = rng.normal(size=(e,) + trailing).astype(np.float32)
    seg = _ids(rng, e, n)
    jd, js = jnp.asarray(data), jnp.asarray(seg)
    td, ts = torch.from_numpy(data), torch.from_numpy(seg)
    for name in ("segment_sum", "segment_mean", "segment_max",
                 "segment_softmax"):
        want = np.asarray(getattr(j_seg, name)(jd, js, n))
        got = getattr(t_seg, name)(td, ts, n).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the empty segment: max -inf, sum 0, mean 0
    assert np.isneginf(t_seg.segment_max(td, ts, n)[0].numpy()).all()


def test_segment_softmax_with_masked_logits_matches_reference():
    """-inf logits (masked edges) and a segment whose logits are all -inf."""
    rng = np.random.default_rng(9)
    e, n, h = 200, 20, 3
    logits = rng.normal(size=(e, h)).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32)
    logits[rng.random(e) < 0.2] = -np.inf
    logits[seg == 4] = -np.inf
    want = np.asarray(j_seg.segment_softmax(jnp.asarray(logits),
                                            jnp.asarray(seg), n))
    got = t_seg.segment_softmax(torch.from_numpy(logits), torch.from_numpy(seg),
                                n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.isfinite(got).all()


def test_unsorted_ids_reference_twin():
    """The reference's ``test_unsorted_ids``: a permuted 10 × 10 grouping of
    ones sums to 10 everywhere, through the port's wrapper."""
    rng = np.random.default_rng(0)
    seg = rng.permutation(np.repeat(np.arange(10), 10)).astype(np.int32)
    out = segment_sum_ref(torch.ones((100, 4)), torch.from_numpy(seg), 10)
    assert bool((out == 10.0).all())
