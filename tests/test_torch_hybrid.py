"""The port's graph side, fusion, planner/executor and facade against the
JAX package's.

The facade tests build the reference ``HMGIIndex`` over a small two-modality
corpus with a typed graph and attribute columns, carry it into the port
with ``convert.index_from_jax_state``, and run the same calls on both.

Tolerances: traversal mass to 1e-5 relative (the port sums each hop as one
sparse product, the reference per query with ``segment_sum``); vector and
fused scores to 1e-5 absolute; ids exactly where scores are distinct
(``assert_topk_match``); ``explain`` strings identical.
"""
import pytest

pytest.importorskip("torch")

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.core import community as jcomm
from repro.core import fusion as jfusion
from repro.core import graph_store as jgraph
from repro.core import traversal as jtrav
from repro.core.index import HMGIIndex as JIndex, _fuse_candidates as j_fuse
from repro.data.synthetic import make_corpus
from repro.query import Q as JQ
from repro.query.executor import _fuse_dense as j_fuse_dense
from repro_torch.configs.base import HMGIConfig
from repro_torch.convert import index_from_jax_state
from repro_torch.core import community as pcomm
from repro_torch.core import delta as pdelta
from repro_torch.core import fusion as pfusion
from repro_torch.core import graph_store as pgraph
from repro_torch.core import traversal as ptrav
from repro_torch.core.index import _fuse_candidates as p_fuse
from repro_torch.query import Q as PQ
from repro_torch.query.executor import _fuse_dense as p_fuse_dense
from test_torch_ivf_topk import assert_topk_match

N = 600


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_nodes=N, modality_dims={"text": 32, "image": 24},
                       intra_p=96 / N, inter_p=2 / N, seed=0)


@pytest.fixture(scope="module")
def graphs(corpus):
    c = corpus
    w = np.random.default_rng(5).random(len(c.src)).astype(np.float32) + 0.5
    return (jgraph.from_edges(N, c.src, c.dst, c.edge_type, w),
            pgraph.from_edges(N, c.src, c.dst, c.edge_type, w, device="cpu"))


def test_graph_store_matches_reference(graphs):
    jg, pg = graphs
    for f in jgraph.GraphStore._fields:
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    np.testing.assert_array_equal(pgraph.degree(pg).numpy(),
                                  np.asarray(jgraph.degree(jg)))
    assert pg.nbytes == jg.nbytes and pg.n_edges == jg.n_edges
    np.testing.assert_array_equal(pgraph.edge_type_lut([3, 0, 3], "cpu").numpy(),
                                  np.asarray(jgraph.edge_type_lut([3, 0, 3])))
    with pytest.raises(ValueError):
        pgraph.edge_type_lut([0.5, 1.0], "cpu")


def _seeds(rng, qn=5, k=12):
    ids = rng.integers(0, N, (qn, k)).astype(np.int32)
    ids[0, -3:] = -1                            # padded result slots
    vals = -np.sort(-rng.random((qn, k)).astype(np.float32), axis=1)
    vals[0, -3:] = -np.inf
    return ids, vals


@pytest.mark.parametrize("edge_types,masked,damping", [
    (None, False, 0.85), ((0, 2), False, 0.85), ((1,), True, 0.6)])
def test_multi_hop_batch_matches_reference(rng, graphs, edge_types, masked,
                                           damping):
    jg, pg = graphs
    ids, vals = _seeds(rng)
    nm = rng.random(N) < 0.7 if masked else None
    jr = jtrav.multi_hop_batch(jg, jnp.asarray(ids), jnp.asarray(vals),
                               n_hops=2, edge_type_mask=edge_types,
                               node_mask=None if nm is None else jnp.asarray(nm),
                               damping=damping)
    pr = ptrav.multi_hop_batch(pg, _t(ids), _t(vals), n_hops=2,
                               edge_type_mask=edge_types,
                               node_mask=None if nm is None else _t(nm),
                               damping=damping)
    assert tuple(pr.shape) == (5, N)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-9)


def test_frontier_expand_and_seeds_match_reference(rng, graphs):
    jg, pg = graphs
    ids, vals = _seeds(rng, qn=1)
    js = jtrav.seeds_from_topk(N, jnp.asarray(ids[0]), jnp.asarray(vals[0]))
    ps = ptrav.seeds_from_topk(N, _t(ids[0]), _t(vals[0]))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6, atol=1e-9)
    for top_m in (0, 20):
        jr = jtrav.frontier_expand(jg, js, n_hops=3, top_m=top_m)
        pr = ptrav.frontier_expand(pg, ps, n_hops=3, top_m=top_m)
        np.testing.assert_allclose(pr.per_hop.numpy(), np.asarray(jr.per_hop),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(pr.total.numpy(), np.asarray(jr.total),
                                   rtol=1e-5, atol=1e-9)


def test_louvain_and_boost_identical(corpus, graphs):
    c = corpus
    jg, pg = graphs
    w = np.ones(len(c.src))
    jl = jcomm.louvain_one_level(N, c.src, c.dst, w)
    pl = pcomm.louvain_one_level(N, c.src, c.dst, w)
    np.testing.assert_array_equal(pl, jl)
    assert pcomm.modularity(N, c.src, c.dst, w, pl) == \
        jcomm.modularity(N, c.src, c.dst, w, jl)
    np.testing.assert_array_equal(pcomm.community_edge_boost(pg, pl).numpy(),
                                  np.asarray(jcomm.community_edge_boost(jg, jl)))


@pytest.mark.parametrize("n_iters", [1, 3, 10])
@pytest.mark.parametrize("which", ["corpus", "sparse"])
def test_label_propagation_identical(graphs, which, n_iters):
    """Integer labels, exactly the reference's: the corpus graph, and a
    sparse random graph of many components with isolated nodes."""
    jg, pg = graphs
    if which == "sparse":
        rng = np.random.default_rng(n_iters)
        src, dst = rng.integers(0, N, (2, N // 3))
        jg = jgraph.from_edges(N, src, dst)
        pg = pgraph.from_edges(N, src, dst, device="cpu")
    want = np.asarray(jcomm.label_propagation(jg, n_iters))
    got = pcomm.label_propagation(pg, n_iters).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _fusion_inputs(rng, qn=4, ks=20):
    gs = (rng.random((qn, N)) ** 4).astype(np.float32)
    vi = rng.integers(0, N, (qn, ks)).astype(np.int32)
    vi[1, 3] = vi[1, 1]                        # a repeated seed
    vi[2, -2:] = -1
    vs = -np.sort(-rng.random((qn, ks)).astype(np.float32), axis=1)
    vs[2, -2:] = -np.inf
    return vs, vi, gs


@pytest.mark.parametrize("filtered", [False, True])
def test_fusion_matches_reference(rng, filtered):
    vs, vi, gs = _fusion_inputs(rng)
    npass = rng.random(N) < 0.6 if filtered else None
    jw = jfusion.adaptive_weights(jnp.asarray(vs))
    pw = pfusion.adaptive_weights(_t(vs))
    np.testing.assert_allclose(pw.w_vector.numpy(), np.asarray(jw.w_vector),
                               rtol=1e-6)
    jnp_pass = None if npass is None else jnp.asarray(npass)
    pt_pass = None if npass is None else _t(npass)
    jr = j_fuse(jnp.asarray(vs), jnp.asarray(vi), jnp.asarray(gs), jw.w_vector,
                jw.w_graph, k_fuse=40, frontier=60, node_pass=jnp_pass)
    pr = p_fuse(_t(vs), _t(vi), _t(gs), pw.w_vector, pw.w_graph, k_fuse=40,
                frontier=60, node_pass=pt_pass)
    assert_topk_match(jr, pr)
    jd = j_fuse_dense(jnp.asarray(vs), jnp.asarray(vi), jnp.asarray(gs),
                      jw.w_vector, jw.w_graph, k_fuse=40, node_pass=jnp_pass)
    pd = p_fuse_dense(_t(vs), _t(vi), _t(gs), pw.w_vector, pw.w_graph,
                      k_fuse=40, node_pass=pt_pass)
    assert_topk_match(jd, pd)
    np.testing.assert_array_equal(
        pfusion.scatter_sim(N, _t(vi), _t(vs)).numpy(),
        np.asarray(jfusion.scatter_sim(N, jnp.asarray(vi), jnp.asarray(vs))))


# ----------------------------------------------------------------- facade
def _cfgs():
    j = jget_config("hmgi").replace(n_partitions=8, n_probe=3, kmeans_iters=4,
                                    delta_capacity=64, maint_auto=False)
    return j, HMGIConfig(**dataclasses.asdict(j))


def _pair(corpus):
    c = corpus
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(7)
    attrs = {"cat": rng.integers(0, 10, N), "year": rng.integers(2000, 2025, N)}
    ji = JIndex(jcfg)
    ji.ingest({m: (c.node_ids[m], c.vectors[m]) for m in ("text", "image")}, N,
              edges=(c.src, c.dst, c.edge_type), node_attrs=attrs)
    tree, meta = ji.state_tree()
    tree = {k: np.asarray(v) for k, v in tree.items()}
    return ji, index_from_jax_state(tree, meta, "cpu", cfg=pcfg)


@pytest.fixture(scope="module")
def pair(corpus):
    return _pair(corpus)


def _queries(corpus, modality, n=8, seed=3):
    rng = np.random.default_rng(seed)
    v = corpus.vectors[modality]
    return v[:n] + 0.05 * rng.normal(size=(n, v.shape[1])).astype(np.float32)


@pytest.mark.parametrize("where,mode", [(None, None),
                                        (("cat", "==", 3), "prefilter"),
                                        (("cat", "!=", 3), "oversample")])
def test_facade_search_matches_reference(corpus, pair, where, mode):
    ji, pi = pair
    q = _queries(corpus, "text")
    assert_topk_match(ji.search(q, "text", where=where),
                      pi.search(q, "text", where=where))
    if mode:
        assert pi.metrics()["filter_mode"] == ji.metrics()["filter_mode"] == mode


@pytest.mark.parametrize("kw", [dict(), dict(edge_type_mask=(0, 2)),
                                dict(where=("cat", "<", 5))],
                         ids=["plain", "typed", "filtered"])
def test_facade_hybrid_matches_reference(corpus, pair, kw):
    ji, pi = pair
    q = _queries(corpus, "text")
    assert_topk_match(ji.hybrid_search(q, "text", n_hops=2, **kw),
                      pi.hybrid_search(q, "text", n_hops=2, **kw))


def _plans(Q, corpus):
    qt, qi = _queries(corpus, "text"), _queries(corpus, "image", seed=4)
    qt2 = _queries(corpus, "text", seed=5)
    return {
        "cross_modal": Q.vector("text", qt).traverse(2)
                        .cross_modal("image", qi, weight=0.3)
                        .topk(10),
        "union": Q.union(Q.vector("text", qt).topk(6),
                         Q.vector("text", qt2).where(("cat", "<", 5))).topk(10),
        "intersect": Q.intersect(Q.vector("text", qt),
                                 Q.vector("text", qt2)).topk(8),
        "typed_filtered": Q.vector("text", qt).where(("year", ">", 2010))
                           .traverse(1, edge_types=(1, 3)).topk(10),
    }


@pytest.mark.parametrize("name", ["cross_modal", "union", "intersect",
                                  "typed_filtered"])
def test_facade_query_and_explain_match_reference(corpus, pair, name):
    ji, pi = pair
    jp, pp = _plans(JQ, corpus)[name], _plans(PQ, corpus)[name]
    assert pi.explain(pp) == ji.explain(jp)
    assert_topk_match(ji.query(jp), pi.query(pp))


def test_memory_usage_matches_reference(pair):
    ji, pi = pair
    assert pi.memory_usage() == ji.memory_usage()


def test_insert_delete_compact_match_reference(corpus):
    """The maint_auto=False write path: updates of existing ids, new ids
    (image nodes gaining a text embedding), deletes, then a compaction."""
    ji, pi = _pair(corpus)
    c = corpus
    rng = np.random.default_rng(11)
    q = _queries(corpus, "text")
    upd = c.node_ids["text"][:4]
    new_ids = c.node_ids["image"][:3]
    vecs = rng.normal(size=(7, 32)).astype(np.float32)
    ids = np.concatenate([upd, new_ids]).astype(np.int32)
    for idx in (ji, pi):
        idx.insert("text", ids, vecs)
    qq = np.concatenate([q, vecs])
    assert_topk_match(ji.search(qq, "text"), pi.search(qq, "text"))
    for idx in (ji, pi):
        idx.delete("text", ids[[0, 5]])
    assert_topk_match(ji.search(qq, "text"), pi.search(qq, "text"))
    assert_topk_match(ji.hybrid_search(qq, "text", n_hops=2),
                      pi.hybrid_search(qq, "text", n_hops=2))
    got = pi.search(vecs, "text")[1].numpy()
    assert got[1, 0] == ids[1] and not np.isin(got, ids[[0, 5]]).any()
    for idx in (ji, pi):
        idx.compact("text")
    assert int(pi.modalities["text"].delta.count) == \
        int(ji.modalities["text"].delta.count)
    assert_topk_match(ji.search(qq, "text", n_probe=8),
                      pi.search(qq, "text", n_probe=8))


def test_state_round_trip_in_port(corpus, pair):
    """state_tree -> restore_state on a fresh port index serves the same
    results (the path chip_smoke.py uses to rebuild an index on the CPU)."""
    from repro_torch.core.index import HMGIIndex
    _, pi = pair
    tree, meta = pi.state_tree()
    back = HMGIIndex(pi.cfg, device="cpu")
    back.restore_state(tree, meta)
    q = _queries(corpus, "text")
    for a, b in ((pi.search(q, "text"), back.search(q, "text")),
                 (pi.hybrid_search(q, "text"), back.hybrid_search(q, "text"))):
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_graph_and_delta_helpers_need_a_device_or_an_explicit_cpu():
    """The index's construction helpers follow the port's entry points:
    with no device they run on the card, and without one they raise,
    naming ``device='cpu'``; given the CPU they build there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    src, dst = np.array([0, 1]), np.array([1, 2])
    calls = {
        "from_edges": lambda **kw: pgraph.from_edges(3, src, dst, **kw),
        "edge_type_lut": lambda **kw: pgraph.edge_type_lut([0, 2], **kw),
        "from_columns": lambda **kw: pgraph.NodeAttributes.from_columns(
            3, {"a": np.zeros(3, np.int32)}, **kw),
        "delta.init": lambda **kw: pdelta.init(4, 2, 8, **kw),
        "as_edge_mask": lambda **kw: ptrav.as_edge_mask([1], **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        out = call(device="cpu")
        leaf = out if isinstance(out, torch.Tensor) else (
            out.values if name == "from_columns" else out[0])
        assert leaf.device.type == "cpu", name
