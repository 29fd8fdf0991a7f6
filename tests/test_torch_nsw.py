"""The port's NSW graph index (``repro_torch.core.nsw``) and the facade's
NSW refine lane against the reference's ``repro.core.nsw``.

- ``build`` with the reference's centroids (``repro.core.partitioner.fit``
  with the key the reference's build uses) gives the reference's
  neighbours up to ties: each list's scores, recomputed in float64 over
  the bf16 rows the build scores, agree within 1e-5 and the ids agree
  wherever the scores are distinct (``assert_topk_match``).
- ``_knn_grouped`` (the build's partition-grouped search) equals
  ``ivf.search(impl="einsum")`` on the same index, up to ties (1e-5).
- ``search`` over a graph carried from the reference gives the same ids
  and scores within 1e-6, where the reference's result holds no duplicate
  id. The reference's visited-bit scatter writes row 0's old bit back for
  every padded neighbour, and XLA on the CPU applies those duplicate
  updates in order, so row 0 can be un-marked and enter the beam twice;
  the port marks only real neighbours (a difference by design). A numpy
  beam search written from the docstring's semantics (``_oracle``) models
  both: with ``ref_scatter=True`` it must equal the reference on every
  query, and with ``ref_scatter=False`` the port on every query (ids
  exactly, scores within 1e-6). The 4-node graph pins the difference.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core import nsw as jnsw
from repro.core import partitioner as jpart
from repro_torch.core import ivf as pivf
from repro_torch.core import nsw as pnsw
from test_torch_ivf_topk import assert_topk_match

SCORE_ATOL = 1e-6   # fp32 dot products of unit rows, summed in another order
TIE_ATOL = 1e-5     # neighbour scores over d ≤ 32 bf16 rows, float64 oracle


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pgraph(jg):
    return pnsw.NSWGraph(_t(jg.vectors), _t(jg.neighbors),
                         torch.tensor(int(jg.entry), dtype=torch.int32))


def _oracle(vec, nbr, entry, q, *, ef, k, max_steps=64, ref_scatter=False):
    """Per-query beam search from ``nsw.search``'s docstring semantics.
    ref_scatter: apply the visited update as XLA on the CPU applies the
    reference's scatter (in order, padded entries writing row 0's old bit
    back); otherwise mark only the fresh neighbours."""
    n = len(vec)
    out_s, out_i = [], []
    for qq in q.astype(np.float32):
        def score(i):
            return np.float32(vec[i] @ qq) if i >= 0 else -np.inf
        ids = [int(entry)] + [-1] * (ef - 1)
        sc = [score(int(entry))] + [-np.inf] * (ef - 1)
        exp = [False] * ef
        visited = np.zeros(n, bool)
        visited[int(entry)] = True
        steps = 0
        while steps < max_steps and any(
                not e and s > -np.inf for e, s in zip(exp, sc)):
            cand = [-np.inf if e else s for e, s in zip(exp, sc)]
            pick = int(np.argmax(cand))
            exp[pick] = True
            node = ids[pick]
            neigh = [int(x) for x in nbr[node]] if node >= 0 else \
                [-1] * nbr.shape[1]
            neigh = [x if x >= 0 and not visited[x] else -1 for x in neigh]
            if ref_scatter:
                old = visited.copy()
                for x in neigh:
                    c = min(max(x, 0), n - 1)
                    visited[c] = old[c] | (x >= 0)
            else:
                for x in neigh:
                    if x >= 0:
                        visited[x] = True
            all_i = ids + neigh
            all_s = sc + [score(x) for x in neigh]
            all_e = exp + [False] * len(neigh)
            order = sorted(range(len(all_s)), key=lambda j: (-all_s[j], j))[:ef]
            ids = [all_i[j] for j in order]
            sc = [all_s[j] for j in order]
            exp = [all_e[j] for j in order]
            steps += 1
        order = sorted(range(ef), key=lambda j: (-sc[j], j))[:min(k, ef)]
        rs = [sc[j] for j in order] + [-np.inf] * (k - min(k, ef))
        ri = [ids[j] for j in order] + [-1] * (k - min(k, ef))
        out_s.append(rs)
        out_i.append(ri)
    return np.asarray(out_s, np.float32), np.asarray(out_i, np.int32)


def _assert_equal(a, b, rows=None):
    sa, ia = (np.asarray(x) for x in a)
    sb, ib = (np.asarray(x) for x in b)
    rows = np.arange(len(ia)) if rows is None else rows
    np.testing.assert_array_equal(ia[rows], ib[rows])
    fin = np.isfinite(sa[rows])
    np.testing.assert_array_equal(fin, np.isfinite(sb[rows]))
    np.testing.assert_allclose(np.where(fin, sa[rows], 0),
                               np.where(fin, sb[rows], 0), rtol=0,
                               atol=SCORE_ATOL)


def _has_dup(row):
    r = row[row >= 0]
    return len(set(r.tolist())) < len(r)


# ------------------------------------------------------------------- search
def test_duplicate_scatter_pin():
    """4 nodes, entry 1: expanding 1 marks rows 0 and 2, then its padded
    neighbour writes row 0's old (False) bit back; row 2's neighbour list
    then finds row 0 fresh again. The reference returns row 0 twice, the
    port once."""
    vec = np.array([[1, 0], [0.9, 0.1], [0.5, 0.5], [0.2, 0.8]], np.float32)
    nbr = np.array([[1, -1, -1], [0, 2, -1], [0, 3, -1], [2, -1, -1]],
                   np.int32)
    q = np.array([[1, 0]], np.float32)
    jg = jnsw.NSWGraph(jnp.asarray(vec), jnp.asarray(nbr), jnp.int32(1))
    _, ji = jnsw.search(jg, jnp.asarray(q), ef=8, k=8)
    _, pi = pnsw.search(_pgraph(jg), _t(q), ef=8, k=8)
    np.testing.assert_array_equal(np.asarray(ji)[0, :5], [0, 0, 1, 2, 3])
    np.testing.assert_array_equal(pi.numpy()[0], [0, 1, 2, 3, -1, -1, -1, -1])
    for ref_scatter, want in ((True, np.asarray(ji)), (False, pi.numpy())):
        _, oi = _oracle(vec, nbr, 1, q, ef=8, k=8, ref_scatter=ref_scatter)
        np.testing.assert_array_equal(oi, want)


def _random_graph(rng, n, d, m, pad_frac):
    vec = _unit(rng, n, d)
    nbr = rng.integers(0, n, (n, m)).astype(np.int32)
    nbr[rng.random((n, m)) < pad_frac] = -1
    nbr = np.sort(nbr, axis=1)[:, ::-1].copy()        # pads last
    return jnsw.NSWGraph(jnp.asarray(vec), jnp.asarray(nbr),
                         jnp.int32(int(rng.integers(0, n))))


@pytest.fixture(scope="module")
def built_graph():
    rng = np.random.default_rng(5)
    x = _unit(rng, 500, 16)
    return jnsw.build(jax.random.PRNGKey(2), jnp.asarray(x), degree=8), rng


@pytest.mark.parametrize("kind,ef,k,max_steps", [
    ("built", 16, 10, 64), ("built", 32, 10, 64), ("built", 8, 12, 64),
    ("random", 16, 10, 64), ("random", 24, 8, 6)])
def test_search_matches_reference(built_graph, kind, ef, k, max_steps):
    jg, _ = built_graph
    rng = np.random.default_rng(ef * 100 + k)
    if kind == "random":
        jg = _random_graph(rng, 300, 16, 6, 0.3)
    q = rng.normal(size=(48, 16)).astype(np.float32)
    ref = jnsw.search(jg, jnp.asarray(q), ef=ef, k=k, max_steps=max_steps)
    got = pnsw.search(_pgraph(jg), _t(q), ef=ef, k=k, max_steps=max_steps)
    ji = np.asarray(ref[1])
    clean = np.array([not _has_dup(r) for r in ji])
    assert clean.any()
    # where the reference holds no duplicate id: the reference itself
    _assert_equal(ref, got, rows=np.nonzero(clean)[0])
    # every query: the oracle of each semantics
    vec, nbr = np.asarray(jg.vectors), np.asarray(jg.neighbors)
    entry = int(jg.entry)
    _assert_equal(ref, _oracle(vec, nbr, entry, q, ef=ef, k=k,
                               max_steps=max_steps, ref_scatter=True))
    _assert_equal(got, _oracle(vec, nbr, entry, q, ef=ef, k=k,
                               max_steps=max_steps, ref_scatter=False))


def test_search_is_batch_independent(built_graph):
    jg, rng = built_graph
    g = _pgraph(jg)
    q = _t(rng.normal(size=(8, 16)).astype(np.float32))
    bs, bi = pnsw.search(g, q, ef=16, k=10)
    for i in range(8):
        s, ids = pnsw.search(g, q[i:i + 1], ef=16, k=10)
        assert torch.equal(s, bs[i:i + 1]) and torch.equal(ids, bi[i:i + 1])


# -------------------------------------------------------------------- build
def _scores(vec, rows, lists):
    """float64 scores of each row against its listed rows, over the
    bf16-rounded vectors the 16-bit build scores."""
    vb = _t(vec).to(torch.bfloat16).float().numpy().astype(np.float64)
    v64 = vec.astype(np.float64)
    s = np.einsum("nd,nmd->nm", v64[rows], vb[np.clip(lists, 0, None)])
    return np.where(lists >= 0, s, -np.inf)


@pytest.mark.parametrize("n,d,degree", [(600, 16, 8), (257, 24, 16),
                                        (40, 8, 16)])
def test_build_matches_reference(n, d, degree):
    rng = np.random.default_rng(n)
    x = _unit(rng, n, d)
    key = jax.random.PRNGKey(n)
    jg = jnsw.build(key, jnp.asarray(x), degree=degree)
    # the reference's own K-means call inside its build
    kp = min(16, n)
    cents = jpart.fit(key, jnp.asarray(x), kp, 16).centroids
    pg = pnsw.build(_t(x), degree=degree, centroids=_t(cents))
    jn, pn = np.asarray(jg.neighbors), pg.neighbors.numpy()
    assert jn.shape == pn.shape == (n, min(degree, n - 1))
    rows = np.arange(n)
    assert_topk_match((_scores(x, rows, jn), jn), (_scores(x, rows, pn), pn),
                      atol=TIE_ATOL)
    np.testing.assert_array_equal(pg.vectors.numpy(), np.asarray(jg.vectors))
    obj = ((x - x.mean(0)) ** 2).sum(1)
    assert int(pg.entry) == int(jg.entry) or \
        abs(obj[int(pg.entry)] - obj[int(jg.entry)]) <= 1e-5


@pytest.mark.parametrize("n,k,bits", [(500, 9, 16), (500, 17, 8),
                                      (40, 17, 16), (300, 5, 4)])
def test_grouped_knn_equals_einsum_route(n, k, bits):
    rng = np.random.default_rng(k + bits)
    x = _t(_unit(rng, n, 24))
    g = torch.Generator().manual_seed(n)
    kp = min(16, n)
    index, _ = pivf.build(x, torch.arange(n, dtype=torch.int32),
                          n_partitions=kp, bits=bits,
                          capacity=max(2 * n // kp + 1, 8), generator=g)
    nq = min(n, 64)
    q = x[:nq] + 0.05 * _t(rng.normal(size=(nq, 24)).astype(np.float32))
    want = pivf.search(index, q, n_probe=4, k=k, impl="einsum")
    got = pnsw._knn_grouped(index, q, n_probe=4, k=k)
    assert_topk_match(want, got, atol=TIE_ATOL)


def test_build_copies_the_vectors():
    """The facade rewrites master rows in place: the graph keeps its own."""
    x = _t(_unit(np.random.default_rng(0), 64, 8))
    g = pnsw.build(x, degree=4, generator=torch.Generator().manual_seed(0))
    x[0] = 0
    assert g.vectors[0].abs().sum() > 0


# ------------------------------------------------------- facade refine lane
@pytest.fixture(scope="module")
def nsw_pair():
    """A reference index with the NSW refine lane, and the port's copy of
    it through ``convert.index_from_jax_state`` (the graph carried over)."""
    import dataclasses
    from repro.configs import get_config as jget_config
    from repro.core.index import HMGIIndex as JIndex
    from repro.data.synthetic import make_corpus
    from repro_torch.configs.base import HMGIConfig
    from repro_torch.convert import index_from_jax_state
    n = 500
    c = make_corpus(n_nodes=n, modality_dims={"text": 32}, intra_p=40 / n,
                    inter_p=2 / n, seed=1)
    jcfg = jget_config("hmgi").replace(
        n_partitions=8, n_probe=2, kmeans_iters=4, delta_capacity=64,
        maint_auto=False, use_nsw_refine=True, nsw_degree=8, nsw_ef=32)
    ji = JIndex(jcfg)
    ji.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, n,
              edges=(c.src, c.dst, c.edge_type),
              node_attrs={"cat": np.random.default_rng(2).integers(0, 4, n)})
    tree, meta = ji.state_tree()
    assert meta["modalities"]["text"]["nsw"]
    pi = index_from_jax_state({k: np.asarray(v) for k, v in tree.items()},
                              meta, "cpu",
                              cfg=HMGIConfig(**dataclasses.asdict(jcfg)))
    return ji, pi, c


def test_converter_carries_the_graph(nsw_pair):
    ji, pi, _ = nsw_pair
    jg, pg = ji.modalities["text"].nsw, pi.modalities["text"].nsw
    for f in pnsw.NSWGraph._fields:
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)))


@pytest.mark.parametrize("call", ["search", "filtered", "hybrid"])
def test_refine_lane_matches_reference(nsw_pair, call):
    """n_probe 2 of 8: the NSW lane adds what the probed partitions miss.
    Scores to 1e-5 (fused hybrid scores), ids up to ties."""
    ji, pi, c = nsw_pair
    rng = np.random.default_rng(9)
    q = c.vectors["text"][:16] + 0.1 * rng.normal(size=(16, 32)).astype(
        np.float32)
    kw = {"search": dict(), "filtered": dict(where=("cat", "==", 1)),
          "hybrid": dict(n_hops=2)}[call]
    fn = "hybrid_search" if call == "hybrid" else "search"
    want = getattr(ji, fn)(q, "text", **kw)
    got = getattr(pi, fn)(q, "text", **kw)
    assert_topk_match(want, got)
    if call == "search":
        # the lane changed the result: the IVF scan alone misses rows
        plain = pi.cfg.replace(use_nsw_refine=False)
        pi.cfg, saved = plain, pi.cfg
        try:
            ivf_only = pi.search(q, "text")
        finally:
            pi.cfg = saved
        assert not np.array_equal(ivf_only[1].numpy(), got[1].numpy())
