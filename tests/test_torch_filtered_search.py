"""Twin of ``tests/test_filtered_search.py`` on the port (indexes on the CPU).

Attribute-filtered search (predicate pushdown) vs the
brute-force-with-predicate oracle.

The oracle scores each row in the representation the index actually stores —
dequantized int8 for stable rows, fp32 master rows for delta rows — so at
full probe the filtered search must reproduce its top-k *exactly*, for both
probe implementations (fused kernel / legacy einsum), across selectivities
from "almost nothing passes" to "almost everything passes" (both sides of
the prefilter-vs-oversample planning crossover).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core import ivf as ivf_mod
from repro_torch.core.cost_model import plan_filtered_scan
from repro_torch.core.graph_store import NodeAttributes
from repro_torch.data.synthetic import make_corpus

N_STABLE = 600
N_DELTA = 16
N_NODES = N_STABLE + N_DELTA
DIM = 32
K = 10
# bucket column ~ Uniform[0, 100): thresholds give the tested selectivities
SELECTIVITY_THRESHOLDS = (1, 10, 50, 90)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(N_STABLE, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bucket = rng.integers(0, 100, N_NODES).astype(np.int32)
    cat = rng.integers(0, 8, N_NODES).astype(np.int32)

    cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=K,
                                     kmeans_iters=6, delta_capacity=64,
                                     delta_rescore_margin=64)
    corpus = make_corpus(n_nodes=N_NODES, modality_dims={"text": DIM}, seed=2)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({"text": (np.arange(N_STABLE, dtype=np.int32), v)},
               n_nodes=N_NODES, edges=(corpus.src, corpus.dst),
               node_attrs={"bucket": bucket, "category": cat})
    # live delta rows on top of the stable index
    dv = rng.normal(size=(N_DELTA, DIM)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    idx.insert("text", np.arange(N_STABLE, N_NODES, dtype=np.int32), dv)
    q = v[:16] + 0.05 * rng.normal(size=(16, DIM)).astype(np.float32)
    return idx, q, bucket, cat


def _as_stored_corpus(idx: HMGIIndex, modality: str):
    """(vectors, ids, valid) of every live row, in the representation the
    index scans: dequantized int8 for stable, fp32 master for delta (latest
    version per id)."""
    m = idx.modalities[modality]
    data, vmin, scale, sids = m.ivf.slab_view()
    stable = ivf_mod._dequant_rows(m.ivf, data, vmin, scale)
    sids = np.asarray(sids)
    dead = np.asarray(m.delta.tombstones) | np.asarray(m.delta.superseded)
    s_ok = (sids >= 0) & ~dead[np.clip(sids, 0, dead.shape[0] - 1)]
    d_ids = np.asarray(m.delta.ids)
    from repro_torch.core.delta import _latest_version_mask
    d_ok = np.asarray(_latest_version_mask(m.delta)) \
        & ~np.asarray(m.delta.tombstones)[np.clip(d_ids, 0, dead.shape[0] - 1)]
    vecs = np.concatenate([np.asarray(stable), np.asarray(m.delta.vectors)])
    ids = np.concatenate([sids, d_ids])
    ok = np.concatenate([s_ok, d_ok])
    return vecs, ids, ok


def _oracle(idx, q, node_pass, k):
    """Brute-force-with-predicate over the stored representation."""
    vecs, ids, ok = _as_stored_corpus(idx, "text")
    ok = ok & node_pass[np.clip(ids, 0, len(node_pass) - 1)]
    qn = np.asarray(idx._norm_queries(q))
    scores = qn @ vecs.T
    scores[:, ~ok] = -np.inf
    order = np.argsort(-scores, axis=1)[:, :k]
    ovals = np.take_along_axis(scores, order, axis=1)
    oids = np.where(np.isfinite(ovals), ids[order], -1)
    return ovals, oids


def _check_exact(sv, si, ovals, oids):
    sv, si = np.asarray(sv), np.asarray(si)
    np.testing.assert_allclose(
        np.where(np.isfinite(sv), sv, 0.0),
        np.where(np.isfinite(ovals), ovals, 0.0), rtol=2e-5, atol=2e-5)
    assert np.all(np.isfinite(sv) == np.isfinite(ovals))
    for a, b, s in zip(si, oids, sv):
        # sets, not sequences: equal scores may legally permute
        assert set(a[np.isfinite(s)].tolist()) == set(
            b[b >= 0].tolist()), (a, b)


class TestFilteredOracle:
    @pytest.mark.parametrize("impl", ["kernel", "einsum"])
    @pytest.mark.parametrize("thresh", SELECTIVITY_THRESHOLDS)
    def test_matches_predicate_oracle(self, setup, impl, thresh):
        idx, q, bucket, _ = setup
        where = ("bucket", "<", thresh)
        node_pass = np.asarray(idx.attributes.node_pass(where))
        sv, si = idx.search(q, "text", k=K, where=where, impl=impl)
        # every hit satisfies the predicate
        for row in np.asarray(si):
            for x in row:
                if x >= 0:
                    assert bucket[x] < thresh
        _check_exact(sv, si, *_oracle(idx, q, node_pass, K))

    def test_planner_crosses_over(self, setup):
        """Low selectivity plans pushdown; high selectivity plans
        oversampling (the cfg crossover is 0.5)."""
        lo = plan_filtered_scan(0.01, K, n_rows=N_NODES)
        hi = plan_filtered_scan(0.9, K, n_rows=N_NODES)
        assert lo.mode == "prefilter"
        assert hi.mode == "oversample" and hi.k_scan > K

    def test_both_plans_agree(self, setup):
        """Forcing prefilter and oversample on the same query must give the
        same answer (planning is a cost decision, not a semantics one)."""
        idx, q, bucket, _ = setup
        where = ("bucket", "<", 50)
        cfg0 = idx.cfg
        try:
            idx.cfg = cfg0.replace(filter_prefilter_max_sel=1.0)
            pv, pi = idx.search(q, "text", k=K, where=where)
            assert idx._metrics["filter_mode"] == "prefilter"
            idx.cfg = cfg0.replace(filter_prefilter_max_sel=0.0)
            ov, oi = idx.search(q, "text", k=K, where=where)
            assert idx._metrics["filter_mode"] == "oversample"
        finally:
            idx.cfg = cfg0
        np.testing.assert_allclose(np.asarray(pv), np.asarray(ov),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(np.asarray(pi), np.asarray(oi))

    def test_conjunction_and_in(self, setup):
        idx, q, bucket, cat = setup
        where = [("category", "in", {1, 3, 5}), ("bucket", ">=", 20)]
        node_pass = np.asarray(idx.attributes.node_pass(where))
        assert node_pass.sum() > 0
        sv, si = idx.search(q, "text", k=K, where=where)
        for row in np.asarray(si):
            for x in row:
                if x >= 0:
                    assert cat[x] in (1, 3, 5) and bucket[x] >= 20
        _check_exact(sv, si, *_oracle(idx, q, node_pass, K))

    def test_oversample_k_beyond_corpus_pads(self, setup):
        """k larger than the scannable rows on the oversample path must pad
        with (-inf, -1), exactly like the unfiltered path."""
        idx, q, bucket, _ = setup
        cfg0 = idx.cfg
        try:
            idx.cfg = cfg0.replace(filter_prefilter_max_sel=0.0)  # force it
            sv, si = idx.search(q[:2], "text", k=N_NODES + 50,
                                where=("bucket", "<", 95))
        finally:
            idx.cfg = cfg0
        sv, si = np.asarray(sv), np.asarray(si)
        assert sv.shape == (2, N_NODES + 50)
        assert np.all(np.isneginf(sv[:, -50:])) and np.all(si[:, -50:] == -1)
        for row, s in zip(si, sv):
            live = row[np.isfinite(s)]
            assert np.all(bucket[live] < 95)

    def test_empty_predicate_returns_nothing(self, setup):
        idx, q, bucket, _ = setup
        sv, si = idx.search(q, "text", k=K, where=("bucket", "<", 0))
        assert not np.any(np.isfinite(np.asarray(sv)))
        assert np.all(np.asarray(si) == -1)

    def test_where_without_attributes_raises(self):
        cfg = get_config("hmgi").replace(n_partitions=4, kmeans_iters=2)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        v = rng.normal(size=(64, 16)).astype(np.float32)
        idx.ingest({"text": (np.arange(64, dtype=np.int32), v)}, n_nodes=64)
        with pytest.raises(ValueError, match="attributes"):
            idx.search(v[:2], "text", k=3, where=("bucket", "<", 5))


class TestFilteredHybrid:
    def test_hybrid_respects_predicate(self, setup):
        idx, q, bucket, _ = setup
        where = ("bucket", "<", 50)
        hv, hi = idx.hybrid_search(q[:6], "text", k=K, n_hops=2, where=where)
        assert hv.shape == (6, K)
        for row in np.asarray(hi):
            for x in row:
                if x >= 0:
                    assert bucket[x] < 50, row

    def test_traversal_routes_no_mass_through_excluded(self, setup):
        """Graph mass never lands on a predicate-excluded node at any hop."""
        from repro_torch.core import traversal as trav_mod
        idx, q, bucket, _ = setup
        node_pass = idx.attributes.node_pass(("bucket", "<", 30))
        seeds = torch.zeros((N_NODES,), dtype=torch.float32)
        seeds[:8] = 1.0 / 8
        res = trav_mod.frontier_expand(idx.graph, seeds, n_hops=3,
                                       node_mask=node_pass)
        mass_on_excluded = np.asarray(res.per_hop)[:, ~np.asarray(node_pass)]
        assert np.all(mass_on_excluded == 0.0)


class TestNodeAttributes:
    def test_ops(self):
        attrs = NodeAttributes.from_columns(
            6, {"a": np.array([0, 1, 2, 3, 4, 5]),
                "b": np.array([5, 5, 0, 0, 5, 5])}, device="cpu")
        def mask(where):
            return np.asarray(attrs.node_pass(where))
        np.testing.assert_array_equal(mask(("a", "==", 2)),
                                      [0, 0, 1, 0, 0, 0])
        np.testing.assert_array_equal(mask(("a", "!=", 2)),
                                      [1, 1, 0, 1, 1, 1])
        np.testing.assert_array_equal(mask(("a", "<=", 1)),
                                      [1, 1, 0, 0, 0, 0])
        np.testing.assert_array_equal(mask(("a", ">", 4)),
                                      [0, 0, 0, 0, 0, 1])
        np.testing.assert_array_equal(mask(("a", "in", {0, 5})),
                                      [1, 0, 0, 0, 0, 1])
        np.testing.assert_array_equal(
            mask([("a", ">=", 1), ("b", "==", 5)]), [0, 1, 0, 0, 1, 1])

    def test_bad_inputs(self):
        attrs = NodeAttributes.from_columns(3, {"a": np.zeros(3, np.int32)},
                                            device="cpu")
        with pytest.raises(ValueError, match="op"):
            attrs.compile_where(("a", "~=", 1))
        with pytest.raises(KeyError):
            attrs.compile_where(("missing", "==", 1))
        with pytest.raises(ValueError, match="shape"):
            NodeAttributes.from_columns(3, {"a": np.zeros(4, np.int32)},
                                        device="cpu")
        assert attrs.node_pass(None) is None
