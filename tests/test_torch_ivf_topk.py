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
import pytest

pytest.importorskip("torch")

import numpy as np
import jax.numpy as jnp
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
    (interpret mode) on every chunk holding a live row. The port chunks
    each probe's rows on their own (a chunk never straddles two probed
    partitions), so the Pallas kernel gets the gathered rows with every
    probe block padded to a chunk multiple by NEG-bias rows, and its argmax
    is mapped back to the query's own rows. cap = 37 straddles (37 = 2·16
    + 5); cap = 32 does not."""
    chunk, n_probe = 16, 3
    q, data, vmin, scale, valid, probes, rows = _probe_case(
        rng, 5, d, 6, cap, n_probe, 0.3)
    nq = q.shape[0]
    nchp = -(-cap // chunk)
    blk = nchp * chunk                         # a probe's padded block
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)

    def per_probe(a, fill):
        a = a[rows].reshape(nq, n_probe, cap, *a.shape[1:])
        widths = [(0, 0), (0, 0), (0, blk - cap)] + [(0, 0)] * (a.ndim - 3)
        a = np.pad(a, widths, constant_values=fill)
        a = a.reshape(nq, n_probe * blk, *a.shape[3:])
        tail = (-a.shape[1]) % 128
        return np.pad(a, [(0, 0), (0, tail)] + [(0, 0)] * (a.ndim - 2),
                      constant_values=fill)

    jm, ja = jkern.scan_topk_pallas_batched(
        jnp.asarray(q), jnp.asarray(per_probe(data, 0)),
        jnp.asarray(per_probe(vmin, 0.0)), jnp.asarray(per_probe(scale, 1.0)),
        jnp.asarray(per_probe(bias, float(ref.NEG))),
        chunk=chunk, block_n=128, interpret=True)
    aff = 128.0 * scale + vmin
    pm, pa = ops.probe_scan(_t(q), _t(q.sum(1)), _t(data), _t(aff), _t(scale),
                            _t(bias), _t(probes), cap, chunk)
    nch = pm.shape[1]
    assert nch == n_probe * nchp
    jm, ja = np.asarray(jm)[:, :nch], np.asarray(ja)[:, :nch]
    ja = ja // blk * cap + ja % blk            # padded axis -> own rows
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
    """Only CPU tensors take the plain version. Meta tensors (the dry run's
    traces) take the CUDA route: its checks, then its outputs allocated,
    nothing computed; a call the card refuses raises there too, instead of
    falling back."""
    q = torch.zeros((2, 16), device="meta")
    rest = (torch.zeros((4, 16), dtype=torch.int8, device="meta"),
            *(torch.zeros(4, device="meta"),) * 3)
    cmax, carg = ops.shared_scan(q, q.sum(1), *rest, 1)
    assert cmax.device.type == carg.device.type == "meta"
    assert tuple(cmax.shape) == (2, 4) and carg.dtype == torch.int32
    with pytest.raises(ValueError):
        ops.shared_scan(q, q.sum(1), *rest, 0)


# ------------------------------------------------- the kernels' limb arithmetic
def _gpu_like_case(rng, nq, d, n_rows):
    """The card tests' operands: random codes, scale ≤ 0.01, randn queries
    (max |q| ≈ 3.5), a fifth of the rows masked."""
    data = rng.integers(-128, 128, (n_rows, d)).astype(np.int8)
    scale = (rng.random(n_rows) / 100).astype(np.float32)
    vmin = (-rng.random(n_rows)).astype(np.float32)
    valid = rng.random(n_rows) > 0.2
    q = rng.normal(size=(nq, d)).astype(np.float32)
    return q, data, vmin, scale, valid


@pytest.mark.parametrize("case", ["randn", "zero_row", "one_large", "d33"])
def test_query_limbs_reconstruct_within_residual(case):
    """q ≈ s·Σ a_i 2^(-7i) within limb_residual(s) per element; a_0 in
    [-127, 127], later limbs in [-64, 64], zeros past d; a zero row has
    s = 0 and no limb bits."""
    rng = np.random.default_rng(7)
    d = 33 if case == "d33" else 64
    q = rng.normal(size=(6, d)).astype(np.float32)
    if case == "zero_row":
        q[2] = 0.0
    if case == "one_large":
        q[1] *= 1e-3
        q[1, 5] = 250.0
    limbs, s = ops.query_limbs(_t(q))
    assert limbs.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(limbs.shape) == (6, ops.N_LIMBS, -(-d // 32) * 32)
    lv = limbs.numpy().astype(np.int64)
    assert np.abs(lv[:, 0]).max() <= 127 and np.abs(lv[:, 1:]).max() <= 64
    assert (lv[:, :, d:] == 0).all()
    steps = 2.0 ** (-7 * np.arange(ops.N_LIMBS))
    rec = ((lv[:, :, :d] * steps[None, :, None]).sum(1)
           * s.numpy()[:, None].astype(np.float64))
    err = np.abs(rec - q.astype(np.float64)).max(1)
    assert (err <= ops.limb_residual(s).numpy()).all(), err
    if case == "zero_row":
        assert float(s[2]) == 0.0 and (lv[2] == 0).all()


def _limb_tolerance(q, data, scale, aff, qsum):
    """Per-query bound of |limb score - exact score|: the limb residual,
    d·128·residual·max|scale|, plus 8 fp32 roundings (2^-24 each) of the
    score's two terms (the limb combination, ·s, ·scale, qsum·aff, adds)."""
    _, s = ops.query_limbs(_t(q))
    d = q.shape[1]
    limb = d * 128 * ops.limb_residual(s).numpy() * np.abs(scale).max()
    dot = np.abs(q.astype(np.float64)) @ np.abs(data.astype(np.float64)).T
    terms = dot * np.abs(scale)[None] + np.abs(qsum)[:, None] * np.abs(aff)[None]
    return limb + 8 * 2.0 ** -24 * terms.max(1)


@pytest.mark.parametrize("d,kind,chunk", [(32, "unit", 16), (33, "unit", 1),
                                          (384, "gpu", 16), (384, "gpu", 7)])
def test_limb_emulation_matches_plain_versions(d, kind, chunk):
    """ref.shared_scan_limbs / probe_scan_limbs (the kernels' arithmetic)
    against the exact float64 scores: every chunk max within
    ``_limb_tolerance``, and the fp32 plain versions within 1e-4 of the
    emulation; chunk argmaxes agree with the plain versions on ≥ 99%."""
    rng = np.random.default_rng(d * 10 + chunk)
    k_parts, cap, n_probe, nq = 5, 37, 3, 6
    n = k_parts * cap
    if kind == "unit":
        data, vmin, scale, valid = _slab(rng, n, d, 0.2)
        q = _queries(rng, nq, d)
    else:
        q, data, vmin, scale, valid = _gpu_like_case(rng, nq, d, n)
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)
    aff = (128.0 * scale + vmin).astype(np.float32)
    qsum = q.sum(1)
    tol = _limb_tolerance(q, data, scale, aff, qsum)
    limbs, s = ops.query_limbs(_t(q))
    exact = ((q.astype(np.float64) @ data.astype(np.float64).T) * scale
             + qsum[:, None].astype(np.float64) * aff + bias)
    probes = np.stack([rng.permutation(k_parts)[:n_probe]
                       for _ in range(nq)]).astype(np.int32)
    common = (_t(qsum), _t(data), _t(aff), _t(scale), _t(bias))
    runs = {
        "shared": (ref.shared_scan_limbs(limbs, s, *common, chunk),
                   ref.shared_scan(_t(q), *common, chunk), exact),
        "probe": (ref.probe_scan_limbs(limbs, s, *common, _t(probes), cap,
                                       chunk),
                  ref.probe_scan(_t(q), *common, _t(probes), cap, chunk),
                  np.stack([exact[i, (probes[i][:, None] * cap
                                      + np.arange(cap)).reshape(-1)]
                            for i in range(nq)])),
    }
    for name, ((em, ea), (pm, pa), ex) in runs.items():
        seg = cap if name == "probe" else n
        want, _ = ref.segment_chunk_max(_t(ex.astype(np.float32)), seg, chunk)
        # the chunk max of the float64 scores, taken in float64
        ex64 = torch.from_numpy(ex)
        want64 = torch.stack([
            ref.segment_chunk_max(ex64[i:i + 1], seg, chunk)[0][0]
            for i in range(nq)]).numpy()
        live = want.numpy() > ref.NEG * 0.5
        err = np.abs(em.numpy().astype(np.float64) - want64)
        assert (np.where(live, err, 0.0) <= tol[:, None]).all(), (name, err.max())
        np.testing.assert_allclose(em.numpy()[live], pm.numpy()[live], rtol=0,
                                   atol=1e-4)
        assert (ea == pa).float().mean().item() >= 0.99, name


def test_probe_topk_finds_a_row_in_a_last_partial_chunk():
    """The best row of every query sits in a probed partition's last,
    partial chunk (cap 37 = 2·16 + 5, local rows 32–36, one per query):
    scan_topk_probe
    returns it first, and its top-k equals the brute-force top-k over the
    quantized scores and the reference wrapper's."""
    rng = np.random.default_rng(3)
    d, k_parts, cap, n_probe, nq, k = 32, 6, 37, 3, 5, 8
    q, data, vmin, scale, valid, probes, rows = _probe_case(
        rng, nq, d, k_parts, cap, n_probe, 0.0)
    data, vmin, scale = data.copy(), vmin.copy(), scale.copy()
    for i in range(nq):
        j = i % n_probe
        r = probes[i, j] * cap + 32 + i
        qv = jquantize(jnp.asarray(q[i:i + 1] * 2.0), 8)   # a longer copy
        data[r], vmin[r] = np.asarray(qv.data[0]), np.asarray(qv.vmin[0, 0])
        scale[r] = np.asarray(qv.scale[0, 0])
    bias = np.zeros(k_parts * cap, np.float32)
    pv, pr = ops.scan_topk_probe(_t(q), _t(data), _t(vmin), _t(scale),
                                 _t(bias), _t(probes), cap, k=k, chunk=16)
    assert (pr[:, 0].numpy() == (np.arange(nq) % n_probe) * cap + 32
            + np.arange(nq)).all()
    deq = (data.astype(np.float64) + 128.0) * scale[:, None] + vmin[:, None]
    brute = np.stack([deq[rows[i]] @ q[i] for i in range(nq)])
    order = np.argsort(-brute, axis=1, kind="stable")[:, :k]
    assert_topk_match((np.take_along_axis(brute, order, 1), order), (pv, pr),
                      atol=1e-5)
    jv, jr = jops.scan_topk_quantized_batched(
        jnp.asarray(q), jnp.asarray(data[rows]), jnp.asarray(vmin[rows]),
        jnp.asarray(scale[rows]), jnp.asarray(np.ones_like(rows, bool)), k=k,
        chunk=16, block_n=512)
    assert_topk_match((jv, jr), (pv, pr))


@pytest.mark.parametrize("chunk", [1, 16, 100])
def test_probe_topk_exact_at_every_chunk(chunk):
    """scan_topk_probe (per-probe kernel chunks + stage-2 rescore) gives the
    exact quantized top-k, the reference wrapper's at chunk 1, whatever the
    chunk: one row per chunk, 16-row chunks (cap 37 is cut 16, 16, 5 in
    every probe) and one chunk longer than a partition."""
    rng = np.random.default_rng(chunk)
    d, cap, n_probe, k = 24, 37, 3, 12
    q, data, vmin, scale, valid, probes, rows = _probe_case(
        rng, 7, d, 6, cap, n_probe, 0.3)
    jv, jr = jops.scan_topk_quantized_batched(
        jnp.asarray(q), jnp.asarray(data[rows]), jnp.asarray(vmin[rows]),
        jnp.asarray(scale[rows]), jnp.asarray(valid[rows]), k=k, chunk=1,
        block_n=512)
    bias = np.where(valid, 0.0, ref.NEG).astype(np.float32)
    pv, pr = ops.scan_topk_probe(_t(q), _t(data), _t(vmin), _t(scale),
                                 _t(bias), _t(probes), cap, k=k, chunk=chunk)
    assert_topk_match((jv, jr), (pv, pr))


def test_search_sharded_single_device(rng):
    """1-shard mesh: sharded search (the kernel path on its one shard) must
    reproduce the local result bit for bit."""
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.sharding import Mesh
    n, d = 512, 32
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    idx, _ = ivf_mod.build(_t(v), torch.arange(n), n_partitions=8, bits=8,
                           generator=torch.Generator().manual_seed(2))
    leaves = ivf_mod.IVFIndex(
        *(getattr(idx, f)[None] for f in ("centroids", "data", "vmin",
                                          "scale", "ids", "counts")),
        bits=idx.bits)
    mesh = Mesh(["cpu"], ("data",))
    q = _t(v[:8])
    sv, si = ivf_mod.search_sharded(leaves, q, mesh, n_probe=8, k=5)
    se, ie = ivf_mod.search(idx, q, n_probe=8, k=5)
    assert torch.equal(sv, se)
    assert torch.equal(si, ie)
