"""Twin of ``tests/test_system.py`` on the port (indexes on the CPU), all
of its cases.

End-to-end behaviour tests for the HMGI system (the paper's claims at
laptop scale): recall, hybrid fusion, dynamic updates, compaction,
workload-aware repartitioning, progressive execution, plan selection."""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core import ivf as ivf_mod
from repro_torch.core.progressive import progressive_search
from repro_torch.core.cost_model import CostModel, select_plan
from repro_torch.data.synthetic import (ground_truth_topk, make_corpus,
                                        recall_at_k)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_nodes=1200, modality_dims={"text": 48, "image": 64},
                       seed=0)


@pytest.fixture(scope="module")
def index(corpus):
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=4, top_k=10,
                                     delta_capacity=256, kmeans_iters=8)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
                for m in corpus.vectors}, n_nodes=corpus.n_nodes,
               edges=(corpus.src, corpus.dst, corpus.edge_type))
    return idx


def _queries(corpus, n=32, seed=7, noise=0.05):
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(corpus.vectors["text"]), n)
    q = corpus.vectors["text"][sel] + noise * rng.normal(
        size=(n, corpus.vectors["text"].shape[1])).astype(np.float32)
    return q


class TestVectorSearch:
    def test_recall_at_probe(self, index, corpus):
        q = _queries(corpus)
        truth = ground_truth_topk(corpus.vectors["text"],
                                  corpus.node_ids["text"], q, 10)
        _, si = index.search(q, "text", k=10)
        assert recall_at_k(np.asarray(si), truth) > 0.8

    def test_recall_improves_with_probe(self, index, corpus):
        q = _queries(corpus)
        truth = ground_truth_topk(corpus.vectors["text"],
                                  corpus.node_ids["text"], q, 10)
        r_low = recall_at_k(np.asarray(index.search(q, "text", k=10, n_probe=1)[1]), truth)
        r_hi = recall_at_k(np.asarray(index.search(q, "text", k=10, n_probe=16)[1]), truth)
        assert r_hi >= r_low
        assert r_hi > 0.95

    def test_modality_isolation(self, index, corpus):
        """Modality-aware partitioning: text queries never return image ids."""
        q = _queries(corpus)
        _, si = index.search(q, "text", k=10)
        text_ids = set(int(i) for i in corpus.node_ids["text"])
        for row in np.asarray(si):
            for i in row:
                if i >= 0:
                    assert int(i) in text_ids


class TestHybrid:
    def test_hybrid_shapes_finite(self, index, corpus):
        q = _queries(corpus, 8)
        hv, hi = index.hybrid_search(q, "text", k=10, n_hops=2)
        assert hv.shape == (8, 10) and hi.shape == (8, 10)
        assert bool(torch.isfinite(hv).all())

    def test_hybrid_includes_vector_hits(self, index, corpus):
        q = _queries(corpus, 4)
        hv, hi = index.hybrid_search(q, "text", k=10, n_hops=2)
        _, vi = index.search(q, "text", k=10)
        overlap = np.mean([len(set(map(int, a)) & set(map(int, b))) / 10
                           for a, b in zip(np.asarray(hi), np.asarray(vi))])
        assert 0.0 < overlap <= 1.0

    def test_plan_selection(self):
        cm = CostModel()
        plan_fast = select_plan(cm, n=10 ** 6, d=384, min_recall=0.5)
        plan_deep = select_plan(cm, n=10 ** 6, d=384, min_recall=0.99)
        assert plan_fast.n_probe <= plan_deep.n_probe
        assert cm.cost(10 ** 6, 384, plan_fast.n_hops, plan_fast.n_probe) <= \
            cm.cost(10 ** 6, 384, plan_deep.n_hops, plan_deep.n_probe)


class TestDynamicUpdates:
    def test_insert_search_delete(self, corpus):
        cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=5,
                                         delta_capacity=128, kmeans_iters=4)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        idx.ingest({"text": (corpus.node_ids["text"], corpus.vectors["text"])},
                   n_nodes=corpus.n_nodes, edges=(corpus.src, corpus.dst))
        nv = np.zeros((4, 48), np.float32)
        nv[np.arange(4), np.arange(4)] = 1.0
        ids = np.arange(4, dtype=np.int32) + 1100
        idx.insert("text", ids, nv)
        _, si = idx.search(nv, "text", k=1)
        assert np.array_equal(np.asarray(si)[:, 0], ids)
        idx.delete("text", ids)
        _, si2 = idx.search(nv, "text", k=1)
        assert not np.any(np.isin(np.asarray(si2), ids))

    def test_update_supersedes_and_compacts(self, corpus):
        cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=3,
                                         delta_capacity=64, kmeans_iters=4)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        idx.ingest({"text": (corpus.node_ids["text"], corpus.vectors["text"])},
                   n_nodes=corpus.n_nodes, edges=(corpus.src, corpus.dst))
        tid = int(corpus.node_ids["text"][0])
        nv = np.zeros((1, 48), np.float32)
        nv[0, 0] = 1.0
        idx.insert("text", np.array([tid]), nv)
        _, si = idx.search(nv, "text", k=1)
        assert int(si[0, 0]) == tid
        idx.compact("text")
        sv, si2 = idx.search(nv, "text", k=1)
        assert int(si2[0, 0]) == tid
        assert float(sv[0, 0]) > 0.99   # latest version, not the stale one

    def test_repartition_trigger(self, index, corpus):
        m = index.modalities["text"]
        m.workload.hits[:] = 0
        m.workload.hits[0] = 10_000   # extreme skew
        assert m.workload.should_repartition()
        assert index.maybe_repartition("text")
        q = _queries(corpus)
        truth = ground_truth_topk(corpus.vectors["text"],
                                  corpus.node_ids["text"], q, 10)
        _, si = index.search(q, "text", k=10, n_probe=16)
        assert recall_at_k(np.asarray(si), truth) > 0.9


class TestProgressive:
    def test_monotone_improvement(self, corpus):
        v = corpus.vectors["text"]
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        idx, _ = ivf_mod.build(torch.as_tensor(v),
                               torch.arange(len(v), dtype=torch.int32),
                               n_partitions=16, bits=8,
                               generator=torch.Generator().manual_seed(1))
        q = _queries(corpus, 16)
        truth = ground_truth_topk(v, np.arange(len(v)), q, 10)
        recalls = [recall_at_k(np.asarray(r.ids), truth)
                   for r in progressive_search(idx, q, k=10)]
        assert all(b >= a - 1e-9 for a, b in zip(recalls, recalls[1:]))
        assert recalls[-1] > 0.9
