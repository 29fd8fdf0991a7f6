"""Twin of ``tests/test_query_engine.py`` on the port (indexes on the CPU).

Declarative query engine vs the brute-force reference interpreter.

Every plan shape the engine supports — seed scans, Where predicates (both
planner modes), typed multi-hop traversal, cross-modal re-scoring, set ops,
and chains thereof — runs at full probe against ``tests/query_ref.py``'s
exhaustive numpy interpreter (stable + delta rows, boosted edge weights).
The facade wrappers (``search`` / ``hybrid_search``) must stay bit-identical
with the plans they compile to. Also the edge_type_mask test coverage:
masked edge types must route no traversal mass, in every spelling."""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core import traversal as trav_mod
from repro_torch.core.graph_store import edge_type_lut, from_edges as graph_from_edges
from repro_torch.query import Q
from repro_torch.query.planner import compile_plan

from torch_query_ref import assert_matches, reference_execute

N = 260
DT, DI = 24, 16
K = 8
N_TYPES = 3


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    vt = _unit(rng.normal(size=(N, DT)).astype(np.float32))
    vi = _unit(rng.normal(size=(N, DI)).astype(np.float32))
    year = rng.integers(2000, 2030, N).astype(np.int32)
    cat = rng.integers(0, 6, N).astype(np.int32)
    e = 2000
    src = rng.integers(0, N, e).astype(np.int32)
    dst = rng.integers(0, N, e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    et = rng.integers(0, N_TYPES, len(src)).astype(np.int32)

    cfg = get_config("hmgi").replace(
        n_partitions=8, n_probe=8, top_k=K, kmeans_iters=6,
        delta_capacity=64, delta_rescore_margin=64)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    ids = np.arange(N, dtype=np.int32)
    # every node carries embeddings in BOTH modalities (cross-modal re-score
    # needs a shared id space with per-modality vectors)
    idx.ingest({"text": (ids, vt), "image": (ids, vi)}, n_nodes=N,
               edges=(src, dst, et), node_attrs={"year": year, "cat": cat})
    # live delta rows on top of the stable index (MVCC update path)
    upd = _unit(rng.normal(size=(6, DT)).astype(np.float32))
    idx.insert("text", np.arange(6, dtype=np.int32), upd)

    q = vt[40:45] + 0.05 * rng.normal(size=(5, DT)).astype(np.float32)
    qi = vi[40:45] + 0.05 * rng.normal(size=(5, DI)).astype(np.float32)
    return idx, q, qi, year, et


def _check(idx, plan, atol=2e-5):
    phys = compile_plan(idx, plan)
    assert_matches((idx.query(plan)), reference_execute(idx, phys),
                   atol=atol)
    return phys


class TestPlanOracle:
    def test_vector_plan(self, setup):
        idx, q, *_ = setup
        _check(idx, Q.vector("text", q).topk(K))

    @pytest.mark.parametrize("thresh", [2004, 2015, 2027])
    def test_filtered_vector_both_modes(self, setup, thresh):
        """Covers both planner filter modes (pushdown at low selectivity,
        oversample at high) against the predicate oracle."""
        idx, q, *_ = setup
        _check(idx, Q.vector("text", q).where(("year", "<", thresh)).topk(K))

    def test_hybrid_chain(self, setup):
        idx, q, *_ = setup
        _check(idx, Q.vector("text", q).traverse(2).topk(K))

    def test_typed_filtered_hybrid_chain(self, setup):
        """Where + Traverse(edge_types=...): the predicate constrains seeds,
        routing and candidates; masked edge types route no mass."""
        idx, q, *_ = setup
        _check(idx, Q.vector("text", q)
                     .where(("year", "<", 2022))
                     .traverse(2, edge_types=(0, 2)).topk(K))

    def test_cross_modal_chain(self, setup):
        idx, q, qi, *_ = setup
        _check(idx, Q.vector("text", q).traverse(1)
                     .cross_modal("image", qi, weight=0.4).topk(K))

    def test_full_chain(self, setup):
        """The acceptance chain: Where + Traverse + CrossModal, stable+delta,
        full probe."""
        idx, q, qi, *_ = setup
        _check(idx, Q.vector("text", q)
                     .where(("year", ">", 2008), ("cat", "in", {0, 1, 2, 3}))
                     .traverse(2, edge_types=(0, 1))
                     .cross_modal("image", qi, weight=0.3).topk(K))

    def test_union(self, setup):
        idx, q, qi, *_ = setup
        _check(idx, Q.union(Q.vector("text", q).topk(16),
                            Q.vector("image", qi).topk(16)).topk(K))

    def test_intersect(self, setup):
        idx, q, *_ = setup
        q2 = np.roll(np.asarray(q), 1, axis=1).astype(np.float32)
        _check(idx, Q.intersect(Q.vector("text", q).topk(48),
                                Q.vector("text", q2).topk(48)).topk(K))

    def test_union_then_traverse(self, setup):
        idx, q, qi, *_ = setup
        _check(idx, Q.union(Q.vector("text", q).topk(12),
                            Q.vector("image", qi).topk(12))
                     .traverse(1).topk(K))

    def test_union_with_outer_where_post_filters(self, setup):
        idx, q, qi, year, _ = setup
        plan = Q.union(Q.vector("text", q).topk(16),
                       Q.vector("image", qi).topk(16)) \
                .where(("year", "<", 2020)).topk(K)
        _check(idx, plan)
        _, ids = idx.query(plan)
        for row in np.asarray(ids):
            for x in row:
                if x >= 0:
                    assert year[x] < 2020

    def test_hops_zero_equals_search(self, setup):
        idx, q, *_ = setup
        sv, si = idx.query(Q.vector("text", q).traverse(0).topk(K))
        rv, ri = idx.search(q, "text", k=K)
        np.testing.assert_array_equal(np.asarray(si), np.asarray(ri))
        np.testing.assert_allclose(np.asarray(sv), np.asarray(rv),
                                   rtol=0, atol=1e-6)

    def test_dense_fusion_plan(self):
        """Tiny corpus: the planner flips to the dense fusion representation
        (frontier covers every node) — must still match the oracle."""
        rng = np.random.default_rng(3)
        n = 24
        v = _unit(rng.normal(size=(n, 12)).astype(np.float32))
        src = rng.integers(0, n, 120).astype(np.int32)
        dst = (src + 1 + rng.integers(0, n - 1, 120).astype(np.int32)) % n
        cfg = get_config("hmgi").replace(n_partitions=4, n_probe=4, top_k=K,
                                         kmeans_iters=4, delta_capacity=32,
                                         delta_rescore_margin=32)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        idx.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n,
                   edges=(src, dst))
        plan = Q.vector("text", v[:4]).traverse(1).topk(K)
        phys = _check(idx, plan)
        assert phys.stages[0].repr == "dense"
        assert "fuse=dense" in idx.explain(plan)

    def test_cross_modal_ignores_deleted_embeddings(self):
        """A tombstoned id in the re-scoring modality must read as 'no
        embedding' (sim2 = 0), not contribute its dead vector."""
        rng = np.random.default_rng(9)
        n = 64
        vt = _unit(rng.normal(size=(n, 12)).astype(np.float32))
        vim = _unit(rng.normal(size=(n, 10)).astype(np.float32))
        cfg = get_config("hmgi").replace(n_partitions=4, n_probe=4, top_k=4,
                                         kmeans_iters=4, delta_capacity=32,
                                         delta_rescore_margin=32)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        ids = np.arange(n, dtype=np.int32)
        idx.ingest({"text": (ids, vt), "image": (ids, vim)}, n_nodes=n)
        q = vt[:2]
        qi = vim[:2]
        _, before = idx.query(Q.vector("text", q)
                               .cross_modal("image", qi, weight=0.5).topk(4))
        victim = int(np.asarray(before)[0, 0])
        idx.delete("image", np.array([victim]))
        plan = Q.vector("text", q).cross_modal("image", qi, weight=0.5).topk(4)
        _check(idx, plan)
        sv, si = idx.query(plan)
        tv, ti = idx.search(q, "text", k=8)
        row = np.asarray(ti)[0].tolist()
        # the victim's rescored value is now (1-w)·text score alone
        if victim in np.asarray(si)[0]:
            pos = np.asarray(si)[0].tolist().index(victim)
            tpos = row.index(victim)
            np.testing.assert_allclose(
                np.asarray(sv)[0, pos],
                0.5 * np.asarray(tv)[0, tpos], rtol=1e-5)

    def test_mvcc_dead_rows_do_not_waste_scan_slots(self):
        """Updates supersede stable rows; at full probe the scan must still
        return the exact visible top-k (visibility pushed into the scan
        validity, gated by the facade's has_dead bit)."""
        rng = np.random.default_rng(10)
        n = 80
        v = _unit(rng.normal(size=(n, 12)).astype(np.float32))
        cfg = get_config("hmgi").replace(n_partitions=4, n_probe=4, top_k=6,
                                         kmeans_iters=4, delta_capacity=32,
                                         delta_rescore_margin=32)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        idx.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n)
        assert not idx.modalities["text"].has_dead
        # update the 4 nearest rows to the query: their stale stable rows
        # would otherwise fill the scan's top slots and get masked to -inf
        idx.insert("text", np.arange(4, dtype=np.int32),
                   _unit(rng.normal(size=(4, 12)).astype(np.float32)))
        assert idx.modalities["text"].has_dead
        _check(idx, Q.vector("text", v[:3]).topk(6))

    def test_min_recall_resolves_probe_width(self, setup):
        idx, q, *_ = setup
        plan = Q.vector("text", q, min_recall=0.99).traverse(1).topk(K)
        phys = _check(idx, plan)
        assert phys.source.n_probe >= 8   # hybrid_deep-class plan


class TestWrapperEquivalence:
    """search/hybrid_search are thin wrappers over the engine — the compiled
    plan must return bit-identical results."""

    def test_search_is_a_plan(self, setup):
        idx, q, *_ = setup
        sv, si = idx.search(q, "text", k=K)
        pv, pi = idx.query(Q.vector("text", q).topk(K))
        np.testing.assert_array_equal(np.asarray(si), np.asarray(pi))
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(pv))

    def test_filtered_search_is_a_plan(self, setup):
        idx, q, *_ = setup
        where = ("year", "<", 2015)
        sv, si = idx.search(q, "text", k=K, where=where)
        pv, pi = idx.query(Q.vector("text", q).where(where).topk(K))
        np.testing.assert_array_equal(np.asarray(si), np.asarray(pi))
        np.testing.assert_array_equal(np.asarray(sv), np.asarray(pv))

    def test_hybrid_search_is_a_plan(self, setup):
        idx, q, _, _, et = setup
        mask = torch.tensor([1.0, 0.0, 1.0])
        hv, hi = idx.hybrid_search(q, "text", k=K, n_hops=2,
                                   edge_type_mask=mask,
                                   where=("year", "<", 2026))
        # the wrapper pre-normalises queries before compiling (its historic
        # double-normalisation); mirror that for bitwise equality
        qn = idx._norm_queries(q)
        pv, pi = idx.query(Q.vector("text", qn)
                            .where(("year", "<", 2026))
                            .traverse(2, edge_types=(0, 2)).topk(K))
        np.testing.assert_array_equal(np.asarray(hi), np.asarray(pi))
        np.testing.assert_array_equal(np.asarray(hv), np.asarray(pv))


class TestEdgeTypeMask:
    """Satellite: type-filtered traversal had zero tests."""

    @pytest.fixture()
    def toy(self):
        # 0 -t0-> 1 -t0-> 2 ; 0 -t1-> 3 ; 3 -t0-> 4
        return graph_from_edges(5, np.array([0, 1, 0, 3]),
                                np.array([1, 2, 3, 4]),
                                edge_type=np.array([0, 0, 1, 0]),
                                device="cpu")

    def test_masked_types_route_no_mass(self, toy):
        seeds = torch.zeros((5,), dtype=torch.float32)
        seeds[0] = 1.0
        res = trav_mod.frontier_expand(
            toy, seeds, n_hops=2, edge_type_mask=torch.tensor([1.0, 0.0]))
        mass = np.asarray(res.per_hop)
        # the only path to 3 (and through it to 4) is the masked type-1 edge
        assert np.all(mass[:, 3] == 0.0) and np.all(mass[:, 4] == 0.0)
        assert mass[0, 1] > 0.0 and mass[1, 2] > 0.0

    def test_unmasked_types_reach(self, toy):
        seeds = torch.zeros((5,), dtype=torch.float32)
        seeds[0] = 1.0
        res = trav_mod.frontier_expand(toy, seeds, n_hops=2)
        assert res.per_hop[0, 3] > 0.0 and res.per_hop[1, 4] > 0.0

    def test_type_id_sequence_equals_mask(self, toy):
        seeds = torch.zeros((5,), dtype=torch.float32)
        seeds[0] = 1.0
        a = trav_mod.frontier_expand(toy, seeds, n_hops=2,
                                     edge_type_mask=torch.tensor([1.0, 0.0]))
        b = trav_mod.frontier_expand(toy, seeds, n_hops=2,
                                     edge_type_mask=(0,))
        np.testing.assert_array_equal(np.asarray(a.per_hop),
                                      np.asarray(b.per_hop))
        # the LUT only spans the requested ids; types beyond it (here
        # type 1) are excluded by the traversal's safe gather
        np.testing.assert_array_equal(np.asarray(edge_type_lut([0], "cpu")), [1.0])

    def test_multi_hop_batch_typed(self, toy):
        ids = torch.tensor([[0]], dtype=torch.int32)
        scores = torch.tensor([[1.0]])
        gs = trav_mod.multi_hop_batch(toy, ids, scores, n_hops=2,
                                      edge_type_mask=(0,))
        gm = trav_mod.multi_hop_batch(toy, ids, scores, n_hops=2,
                                      edge_type_mask=torch.tensor([1.0, 0.0]))
        np.testing.assert_array_equal(np.asarray(gs), np.asarray(gm))
        assert np.all(np.asarray(gs)[0, [3, 4]] == 0.0)

    def test_engine_typed_traverse_matches_oracle(self, setup):
        idx, q, *_ = setup
        for types in [(0,), (1, 2)]:
            _check(idx, Q.vector("text", q)
                        .traverse(2, edge_types=types).topk(K))

    def test_edge_type_lut_rejects_bad_input(self):
        with pytest.raises(ValueError, match="empty"):
            edge_type_lut([], "cpu")
        with pytest.raises(ValueError, match="non-negative"):
            edge_type_lut([-1], "cpu")
        # a float list is a mask spelled wrong, not a set of type ids —
        # reinterpreting it would silently invert the filter
        with pytest.raises(ValueError, match="mask"):
            edge_type_lut([1.0, 0.0], "cpu")


class TestExplain:
    def test_filter_mode_reported(self, setup):
        idx, q, *_ = setup
        lo = idx.explain(Q.vector("text", q).where(("year", "<", 2004)).topk(K))
        hi = idx.explain(Q.vector("text", q).where(("year", "<", 2028)).topk(K))
        assert "filter=prefilter" in lo
        assert "filter=oversample" in hi

    def test_stage_order_and_widths(self, setup):
        idx, q, qi, *_ = setup
        s = idx.explain(Q.vector("text", q).traverse(2, edge_types=(0,))
                         .cross_modal("image", qi).topk(K))
        assert s.index("seed[") < s.index("traverse[") < s.index("rescore[")
        assert "typed" in s and "fuse=sparse" in s and f"topk({K})" in s

    def test_explain_is_side_effect_free(self, setup):
        """explain() compiles but must not clobber the execution metrics
        (benchmarks and tests read _metrics after a search)."""
        idx, q, *_ = setup
        idx.search(q, "text", k=K, where=("year", "<", 2004))
        mode = idx._metrics["filter_mode"]
        sel = idx._metrics["filter_selectivity"]
        idx.explain(Q.vector("text", q).where(("year", "<", 2028)).topk(K))
        assert idx._metrics["filter_mode"] == mode
        assert idx._metrics["filter_selectivity"] == sel

    def test_traverse_without_graph_raises(self):
        cfg = get_config("hmgi").replace(n_partitions=4, kmeans_iters=2)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        v = rng.normal(size=(32, 8)).astype(np.float32)
        idx.ingest({"text": (np.arange(32, dtype=np.int32), v)}, n_nodes=32)
        with pytest.raises(ValueError, match="graph"):
            idx.query(Q.vector("text", v[:2]).traverse(1).topk(4))
