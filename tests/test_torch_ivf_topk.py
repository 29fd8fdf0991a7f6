"""The port's scan kernels (``repro_torch.kernels.ivf_topk``) against the
JAX package's Pallas kernels and wrappers.

On the CPU the port's wrappers run the plain versions (``ref.py``); the JAX
side runs as its own tests run it (Pallas in interpret mode). Inputs are
made with numpy and handed to both. The CUDA kernels themselves are held
against the plain versions in ``test_torch_kernels_gpu.py``, on a card only.

Tolerance: scores agree to 1e-5 absolute (fp32 dot products over d ≤ 64 of
O(1) terms, summed in another order); ids agree exactly wherever scores
are distinct, and as sets within a run of tied scores (``torch.topk`` makes
no promise about tie order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.quantization import quantize as jquantize
from repro.kernels.ivf_topk import ivf_topk as jkern
from repro.kernels.ivf_topk import ops as jops
from repro.kernels.ivf_topk import ref as jref
from repro_torch.kernels.ivf_topk import ops, ref

ATOL = 1e-5


def assert_topk_match(expected, got, atol=ATOL):
    """Tie-tolerant top-k equality: same finiteness, scores within atol,
    (-inf, -1) padding equal, and per run of tied scores the same id set
    (a run that reaches the end of the list may be cut differently)."""
    rs, ri = (np.asarray(a) for a in expected)
    gs, gi = (np.asarray(a) for a in got)
    assert rs.shape == gs.shape and ri.shape == gi.shape
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(fin, np.isfinite(gs))
    np.testing.assert_allclose(np.where(fin, gs, 0.0), np.where(fin, rs, 0.0),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(ri[~fin], gi[~fin])
    for r_s, r_i, g_i, f in zip(rs, ri, gi, fin):
        n = int(f.sum())
        j = 0
        while j < n:
            e = j + 1
            while e < n and abs(r_s[e] - r_s[j]) <= atol:
                e += 1
            if e < n or n < len(r_s):
                assert set(r_i[j:e].tolist()) == set(g_i[j:e].tolist()), \
                    (r_i[j:e], g_i[j:e])
            j = e


def _slab(rng, rows, d, masked=0.2):
    v = rng.normal(size=(rows, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    qv = jquantize(jnp.asarray(v), 8)
    data = np.asarray(qv.data)
    vmin = np.asarray(qv.vmin[:, 0])
    scale = np.asarray(qv.scale[:, 0])
    valid = rng.random(rows) >= masked
    return data, vmin, scale, valid


def _queries(rng, nq, d):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _probe_case(rng, nq, d, k_parts, cap, n_probe, masked):
    data, vmin, scale, valid = _slab(rng, k_parts * cap, d, masked)
    q = _queries(rng, nq, d)
    probes = np.stack([rng.permutation(k_parts)[:n_probe]
                       for _ in range(nq)]).astype(np.int32)
    rows = (probes[:, :, None] * cap + np.arange(cap)[None, None, :]
            ).reshape(nq, -1)
    return q, data, vmin, scale, valid, probes, rows


@pytest.mark.parametrize("d,cap,n_probe,k,masked", [
    (24, 37, 3, 10, 0.2),      # cap not a multiple of 16, ragged tail
    (32, 16, 4, 8, 0.0),       # whole chunks, nothing masked
    (32, 21, 2, 60, 0.5),      # k larger than the live rows: -inf/-1 pads
])
def test_probe_topk_matches_reference(rng, d, cap, n_probe, k, masked):
    """scan_topk_probe (flat slab + probe list) == the reference wrapper fed
    the gathered (Q, M, d) form of the same rows."""
    q, data, vmin, scale, valid, probes, rows = _probe_case(
        rng, 6, d, 8, cap, n_probe, masked)
    jv, jr = jops.scan_topk_quantized_batched(
        jnp.asarray(q), jnp.asarray(data[rows]), jnp.asarray(vmin[rows]),
        jnp.asarray(scale[rows]), jnp.asarray(valid[rows]), k=k, chunk=16,
        block_n=512)
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)
    pv, pr = ops.scan_topk_probe(_t(q), _t(data), _t(vmin), _t(scale),
                                 _t(bias), _t(probes), cap, k=k, chunk=16)
    assert pv.dtype == torch.float32 and tuple(pv.shape) == (6, k)
    assert_topk_match((jv, jr), (pv, pr))


@pytest.mark.parametrize("d,cap", [(24, 37), (32, 32)])
def test_probe_scan_chunks_match_pallas_kernel(rng, d, cap):
    """The plain probe scan's per-chunk (max, argmax) == the Pallas kernel's
    (interpret mode) on every chunk holding a live row."""
    q, data, vmin, scale, valid, probes, rows = _probe_case(
        rng, 5, d, 6, cap, 3, 0.3)
    m = rows.shape[1]
    mp = -(-m // 128) * 128
    pad = mp - m
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)
    jm, ja = jkern.scan_topk_pallas_batched(
        jnp.asarray(q), jnp.pad(jnp.asarray(data[rows]), ((0, 0), (0, pad), (0, 0))),
        jnp.pad(jnp.asarray(vmin[rows]), ((0, 0), (0, pad))),
        jnp.pad(jnp.asarray(scale[rows]), ((0, 0), (0, pad)), constant_values=1.0),
        jnp.pad(jnp.asarray(bias[rows]), ((0, 0), (0, pad)),
                constant_values=float(ref.NEG)),
        chunk=16, block_n=128, interpret=True)
    aff = 128.0 * scale + vmin
    pm, pa = ops.probe_scan(_t(q), _t(q.sum(1)), _t(data), _t(aff), _t(scale),
                            _t(bias), _t(probes), cap, 16)
    nch = pm.shape[1]
    assert nch == -(-m // 16)
    jm, ja = np.asarray(jm)[:, :nch], np.asarray(ja)[:, :nch]
    live = jm > ref.NEG * 0.5
    assert live.any() and (live == (pm.numpy() > ref.NEG * 0.5)).all()
    np.testing.assert_allclose(pm.numpy()[live], jm[live], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pa.numpy()[live], ja[live])


@pytest.mark.parametrize("n,chunk,k", [(100, 1, 20), (300, 128, 5),
                                       (40, 1, 64)])
def test_shared_topk_matches_reference(rng, n, chunk, k):
    """scan_topk_quantized (shared slab, ragged N, no padding copy) == the
    reference wrapper; k beyond the rows pads (-inf, -1)."""
    d = 32
    data, vmin, scale, valid = _slab(rng, n, d, 0.3)
    q = _queries(rng, 7, d)
    jv, ji = jops.scan_topk_quantized(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray(vmin),
        jnp.asarray(scale), jnp.asarray(valid), k=k, chunk=chunk, block_n=128)
    pv, pi = ops.scan_topk_quantized(_t(q), _t(data), _t(vmin), _t(scale),
                                     _t(valid), k=k, chunk=chunk)
    assert_topk_match((jv, ji), (pv, pi))


def test_shared_scan_chunks_match_pallas_kernel(rng):
    d, n = 24, 256
    data, vmin, scale, valid = _slab(rng, n, d, 0.25)
    q = _queries(rng, 4, d)
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)
    jm, ja = jkern.scan_topk_pallas(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray(vmin), jnp.asarray(scale),
        jnp.asarray(bias), chunk=16, block_n=128, interpret=True)
    pm, pa = ops.shared_scan(_t(q), _t(q.sum(1)), _t(data),
                             _t(128.0 * scale + vmin), _t(scale), _t(bias), 16)
    live = np.asarray(jm) > ref.NEG * 0.5
    np.testing.assert_allclose(pm.numpy()[live], np.asarray(jm)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pa.numpy()[live], np.asarray(ja)[live])


def test_chunk_argmax_takes_first_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 0.0, 2.0, 2.0]])
    vals, arg = ref.chunk_max(s, 4)
    assert vals.tolist() == [[3.0, 2.0]]
    assert arg.tolist() == [[1, 4]]           # ragged tail padded with NEG


def test_pad_and_topk_from_chunks_match_reference(rng):
    cm = rng.normal(size=(3, 9)).astype(np.float32)
    ca = rng.integers(0, 100, (3, 9)).astype(np.int32)
    for k in (4, 12):
        assert_topk_match(jref.topk_from_chunks(jnp.asarray(cm), jnp.asarray(ca), k),
                          ref.topk_from_chunks(_t(cm), _t(ca), k))


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back."""
    q = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError):
        ops.shared_scan(q, q.sum(1), torch.zeros((4, 16), dtype=torch.int8,
                                                 device="meta"),
                        *(torch.zeros(4, device="meta"),) * 3, 1)

