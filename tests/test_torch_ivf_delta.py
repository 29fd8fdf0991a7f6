"""The port's partitioner, IVF and MVCC delta store against the JAX
package's.

K-means seeds with ``jax.random.choice``, which torch cannot reproduce, so
the tests hand the reference's centroids (or its initial sample indices) to
the port. Layouts, codes and MVCC state are compared exactly; scores to
1e-5 absolute (fp32 sums in another order over unit-norm rows); ids exactly
where scores are distinct (``assert_topk_match``).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core import delta as jdelta
from repro.core import ivf as jivf
from repro.core import partitioner as jpart
from repro_torch.core import delta as pdelta
from repro_torch.core import ivf as pivf
from repro_torch.core import partitioner as ppart
from test_torch_ivf_topk import assert_topk_match


def _corpus(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(port, ref):
    r = np.asarray(ref)
    if r.dtype == jnp.bfloat16:             # bf16 passthrough: exact in fp32
        r, port = r.astype(np.float32), port.float()
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(p, r)


def _same_ivf(p, j):
    for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
        _same(getattr(p, f), getattr(j, f))
    assert p.bits == j.bits


def _same_delta(p, j):
    """Every field equal, except the int8 mirror: the reference quantizes
    delta rows inside ``jax.jit``, where XLA turns ``range / 255`` into
    ``range * (1/255)``, so its qscale can differ in the last bit and a code
    by one level from the eager ``quantize`` the port (and the reference's
    own stable build) uses — see ``test_delta_codes_follow_eager_quantize``.
    The delta's exact fp32 rescore makes search results agree regardless."""
    for f in jdelta.DeltaStore._fields:
        if f == "qdata":
            diff = p.qdata.numpy().astype(int) - np.asarray(j.qdata).astype(int)
            assert np.abs(diff).max() <= 1
        elif f == "qscale":
            np.testing.assert_allclose(p.qscale.numpy(), np.asarray(j.qscale),
                                       rtol=2e-7, atol=0)
        else:
            _same(getattr(p, f), getattr(j, f))


def _ref_index(rng, n=600, d=32, k=8, capacity=None, bits=8):
    v = _corpus(rng, n, d)
    ids = np.arange(n, dtype=np.int32) * 2 + 1          # sparse global ids
    j, jo = jivf.build(jax.random.PRNGKey(0), jnp.asarray(v), jnp.asarray(ids),
                       n_partitions=k, capacity=capacity, bits=bits,
                       kmeans_iters=4)
    p, po = pivf.build(_t(v), _t(ids), n_partitions=k, capacity=capacity,
                       bits=bits, centroids=_t(j.centroids))
    return v, ids, j, jo, p, po


@pytest.mark.parametrize("bits,capacity", [(8, None), (8, 40), (4, None),
                                           (16, 50)])
def test_build_identical_layout(rng, bits, capacity):
    """Same slot for every row (ascending input order within a partition),
    identical codes, counts and overflow — capacity 40/50 forces overflow."""
    _, _, j, jo, p, po = _ref_index(rng, capacity=capacity, bits=bits)
    _same_ivf(p, j)
    _same(po, jo)
    if capacity:
        assert bool(po.any())


def test_fit_with_injected_samples(rng):
    x = _corpus(rng, 500, 24)
    key = jax.random.PRNGKey(3)
    idx0 = np.asarray(jax.random.choice(key, 500, (6,), replace=False))
    js = jpart.fit(key, jnp.asarray(x), 6, 8)
    ps = ppart.fit(_t(x), 6, 8, init_idx=_t(idx0))
    np.testing.assert_allclose(ps.centroids.numpy(), np.asarray(js.centroids),
                               rtol=0, atol=1e-5)
    _same(ps.counts, js.counts)
    np.testing.assert_allclose(float(ps.inertia), float(js.inertia), rtol=1e-5)


def test_assignment_and_parked_sentinel(rng):
    x = _corpus(rng, 200, 24)
    c = _corpus(rng, 7, 24)
    c[2] = jpart.parked_centroid(24)
    np.testing.assert_array_equal(ppart.parked_centroid(24),
                                  jpart.parked_centroid(24))
    _same(ppart.assign(_t(x), _t(c)), jpart.assign(jnp.asarray(x), jnp.asarray(c)))
    pi, pv = ppart.assign_topk(_t(x), _t(c), 3)
    ji, jv = jpart.assign_topk(jnp.asarray(x), jnp.asarray(c), 3)
    _same(pi, ji)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    pa, pd = ppart.assign_with_distance(_t(x), _t(c))
    ja, jd = jpart.assign_with_distance(jnp.asarray(x), jnp.asarray(c))
    _same(pa, ja)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    assert not (pi.numpy() == 2).any()            # parked: never probed
    np.testing.assert_array_equal(ppart.parked_mask(_t(c)), jpart.parked_mask(c))
    assert ppart.live_partitions(_t(c)) == jpart.live_partitions(c) == 6


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("n_probe", [3, 8])
@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_search_matches_reference(rng, impl, n_probe, filtered):
    """Partial and full probe, with and without the node_pass pushdown."""
    v, ids, j, _, p, _ = _ref_index(rng)
    q = v[:12] + 0.05 * rng.normal(size=(12, 32)).astype(np.float32)
    npass = rng.random(1300) < 0.4 if filtered else None
    kw_j = {} if npass is None else {"node_pass": jnp.asarray(npass)}
    kw_p = {} if npass is None else {"node_pass": _t(npass)}
    jv, ji = jivf.search(j, jnp.asarray(q), n_probe=n_probe, k=10, impl=impl,
                         **kw_j)
    pv, pi = pivf.search(p, _t(q), n_probe=n_probe, k=10, impl=impl, **kw_p)
    assert_topk_match((jv, ji), (pv, pi))
    if npass is not None:
        got = pi.numpy()
        assert npass[got[got >= 0]].all()


def test_merges_and_brute_force(rng):
    sa = -np.sort(-rng.random((4, 6)).astype(np.float32), axis=1)
    sb = -np.sort(-rng.random((4, 6)).astype(np.float32), axis=1)
    ia = rng.integers(0, 10, (4, 6)).astype(np.int32)
    ib = rng.integers(0, 10, (4, 6)).astype(np.int32)
    ia[0, 1] = -1
    def masked(vals, ids):        # callers drop the ids of -inf slots
        vals, ids = np.asarray(vals), np.asarray(ids)
        return vals, np.where(np.isfinite(vals), ids, -1)
    for k in (5, 12):
        assert_topk_match(
            masked(*jivf.dedup_merge_topk(jnp.asarray(sa), jnp.asarray(ia),
                                          jnp.asarray(sb), jnp.asarray(ib), k)),
            masked(*pivf.dedup_merge_topk(_t(sa), _t(ia), _t(sb), _t(ib), k)))
    ib2 = ib + 100
    assert_topk_match(
        jivf.merge_topk(jnp.asarray(sa), jnp.asarray(ia), jnp.asarray(sb),
                        jnp.asarray(ib2), 7),
        pivf.merge_topk(_t(sa), _t(ia), _t(sb), _t(ib2), 7))
    v = _corpus(rng, 50, 16)
    valid = rng.random(50) < 0.7
    q = _corpus(rng, 3, 16)
    assert_topk_match(
        jivf.brute_force(jnp.asarray(v), jnp.asarray(valid),
                         jnp.arange(50) + 7, jnp.asarray(q), k=5),
        pivf.brute_force(_t(v), _t(valid), torch.arange(50) + 7, _t(q), k=5))


def test_slot_surgery_matches_reference(rng):
    _, _, j, _, p, _ = _ref_index(rng)
    rows = np.array([3, 77, 150])
    gj, gp = jivf.gather_slots(j, rows), pivf.gather_slots(p, rows)
    for a, b in zip(gp, gj):
        _same(a, b)
    j2 = jivf.set_slots(j, np.array([5, 6, 7]), *gj)
    p2 = pivf.set_slots(p, np.array([5, 6, 7]), *gp)
    _same_ivf(p2, j2)
    _same_ivf(pivf.clear_slots(p2, rows), jivf.clear_slots(j2, rows))
    _same_ivf(p, j)                        # inputs untouched


def _delta_pair(rng, d=16, cap=16, max_ids=64):
    return (jdelta.init(cap, d, max_ids), pdelta.init(cap, d, max_ids, "cpu"))


def test_delta_writes_match_reference(rng):
    """insert (same-id rows inside one batch and across batches), supersede,
    delete, re-insert of a deleted id, and growth past the capacity."""
    d = 16
    j, p = _delta_pair(rng, d)
    steps = [
        ("insert", [1, 2, 1, 3]),
        ("insert", [2, 5, 6]),
        ("supersede", [9, 10]),
        ("delete", [5, 40]),
        ("insert", [5, 7, 7]),
    ]
    for op, ids in steps:
        ids = np.asarray(ids, np.int32)
        if op == "insert":
            v = _corpus(rng, len(ids), d)
            j = jdelta.insert(j, jnp.asarray(v), jnp.asarray(ids))
            p = pdelta.insert(p, _t(v), _t(ids))
        elif op == "supersede":
            j, p = jdelta.supersede(j, jnp.asarray(ids)), pdelta.supersede(p, _t(ids))
        else:
            j, p = jdelta.delete(j, jnp.asarray(ids)), pdelta.delete(p, _t(ids))
        _same_delta(p, j)
    v = _corpus(rng, 20, d)
    big = np.arange(20, dtype=np.int32) + 20
    j = jdelta.insert_grow(j, jnp.asarray(v), jnp.asarray(big))
    p = pdelta.insert_grow(p, _t(v), _t(big))
    _same_delta(p, j)
    assert pdelta.free_slots(p) == jdelta.free_slots(j)
    assert pdelta.should_compact(p) == jdelta.should_compact(j)
    np.testing.assert_array_equal(pdelta.live_slots(p), jdelta.live_slots(j))
    keep = pdelta.live_slots(p)[::2]
    _same_delta(pdelta.rebuild_keep(p, keep, [9]),
                jdelta.rebuild_keep(j, keep, [9]))


@pytest.mark.parametrize("filtered", [False, True])
def test_scan_delta_matches_reference(rng, filtered):
    d = 16
    j, p = _delta_pair(rng, d, cap=64)
    v = _corpus(rng, 40, d)
    ids = rng.permutation(60)[:40].astype(np.int32)
    ids[5] = ids[4]                          # a stale version in the store
    j = jdelta.delete(jdelta.insert(j, jnp.asarray(v), jnp.asarray(ids)),
                      jnp.asarray(ids[:3]))
    p = pdelta.delete(pdelta.insert(p, _t(v), _t(ids)), _t(ids[:3]))
    q = _corpus(rng, 6, d)
    npass = rng.random(64) < 0.5 if filtered else None
    jv = jdelta._scan_delta(j, jnp.asarray(q), k=5, margin=4,
                            node_pass=None if npass is None else jnp.asarray(npass))
    pv = pdelta._scan_delta(p, _t(q), k=5, margin=4,
                            node_pass=None if npass is None else _t(npass))
    assert_topk_match(jv, pv)


@pytest.mark.parametrize("filtered", [False, True])
def test_scan_delta_many_live_rows_matches_reference(filtered):
    """A delta with far more live rows than k + margin (cap 512, 300
    inserted, a stale version, 3 deletes): the port's scan gives the
    reference's results."""
    rng = np.random.default_rng(11 + filtered)
    d = 16
    j, p = jdelta.init(512, d, 400), pdelta.init(512, d, 400, "cpu")
    v = _corpus(rng, 300, d)
    ids = rng.permutation(400)[:300].astype(np.int32)
    ids[7] = ids[6]                          # a stale version in the store
    j = jdelta.delete(jdelta.insert(j, jnp.asarray(v), jnp.asarray(ids)),
                      jnp.asarray(ids[:3]))
    p = pdelta.delete(pdelta.insert(p, _t(v), _t(ids)), _t(ids[:3]))
    q = _corpus(rng, 9, d)
    npass = rng.random(400) < 0.5 if filtered else None
    jv = jdelta._scan_delta(j, jnp.asarray(q), k=5, margin=4,
                            node_pass=None if npass is None else jnp.asarray(npass))
    pv = pdelta._scan_delta(p, _t(q), k=5, margin=4,
                            node_pass=None if npass is None else _t(npass))
    assert_topk_match(jv, pv)


def test_search_with_delta_and_compact_match_reference(rng):
    """Stable ∪ delta with an update, a delete and stable overflow, then a
    full compaction: same search results and the same rebuilt bytes."""
    v, ids, j, jo, p, po = _ref_index(rng, capacity=70)
    d = v.shape[1]
    jd, pd = _delta_pair(rng, d, cap=256, max_ids=1300)
    over = np.asarray(jo)
    jd = jdelta.insert(jd, jnp.asarray(v[over]), jnp.asarray(ids[over]))
    pd = pdelta.insert(pd, _t(v[over]), _t(ids[over]))
    upd = ids[[0, 10, 20]]
    newv = _corpus(rng, 3, d)
    jd = jdelta.insert(jdelta.supersede(jd, jnp.asarray(upd)),
                       jnp.asarray(newv), jnp.asarray(upd))
    pd = pdelta.insert(pdelta.supersede(pd, _t(upd)), _t(newv), _t(upd))
    jd, pd = jdelta.delete(jd, jnp.asarray(ids[5:8])), pdelta.delete(pd, _t(ids[5:8]))
    q = np.concatenate([newv, v[30:36]])
    for n_probe in (2, 8):
        assert_topk_match(
            jdelta.search_with_delta(j, jd, jnp.asarray(q), n_probe=n_probe,
                                     k=8, rescore_margin=8),
            pdelta.search_with_delta(p, pd, _t(q), n_probe=n_probe, k=8,
                                     rescore_margin=8))
    allv = v.copy()
    allv[[0, 10, 20]] = newv
    ji, jf = jdelta.compact(jax.random.PRNGKey(1), j, jd, jnp.asarray(allv),
                            jnp.asarray(ids))
    pi, pf = pdelta.compact(p, pd, _t(allv), _t(ids))
    _same_ivf(pi, ji)
    _same_delta(pf, jf)


def test_delta_codes_follow_eager_quantize(rng):
    """Pins the one byte-level difference from the reference: its jitted
    delta insert computes scale = range·(1/255) (XLA's divide-by-constant
    rewrite) where eager ``quantize`` divides by 255. The port's delta holds
    exactly the eager codes — the same bytes the reference's stable build
    stores for a row — and the reference's differ by at most one level."""
    from repro.core.quantization import quantize as jquantize
    from repro_torch.core.quantization import quantize as pquantize
    d = 16
    v = rng.normal(size=(400, d)).astype(np.float32)
    ids = np.arange(400, dtype=np.int32)
    j = jdelta.insert(jdelta.init(512, d, 512), jnp.asarray(v), jnp.asarray(ids))
    p = pdelta.insert(pdelta.init(512, d, 512, "cpu"), _t(v), _t(ids))
    eager = pquantize(_t(v), 8)
    np.testing.assert_array_equal(eager.data.numpy(),
                                  np.asarray(jquantize(jnp.asarray(v), 8).data))
    np.testing.assert_array_equal(p.qdata[:400].numpy(), eager.data.numpy())
    np.testing.assert_array_equal(p.qscale[:400].numpy(), eager.scale[:, 0].numpy())
    ref_codes = np.asarray(j.qdata[:400]).astype(int)
    assert 0 < np.sum(ref_codes != eager.data.numpy()) < ref_codes.size // 20
    assert np.abs(ref_codes - eager.data.numpy()).max() == 1
