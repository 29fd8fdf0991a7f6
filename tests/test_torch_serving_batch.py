"""Twin of ``tests/test_serving_batch.py`` on the port (indexes on the CPU).

Serving micro-batch oracle: a ``(Q, k)`` bucketed retrieval must be
bit-identical to Q sequential ``(1, k)`` retrievals through the same
serving entry, for every bucket size, stable+delta, with and without
``where=`` — and the cross-request ``MicroBatcher`` must preserve that
contract under real concurrency, including mixed-plan batches (which fall
back to one bucketed call per plan group) and exact-duplicate dedup.

The bucketed entry (``search_bucketed``) pads every batch to a pow2
bucket >= 2: XLA:CPU specialises the Q=1 contraction differently from
Q>=2 (last-bit fp divergence), but for every Q>=2 each row's result is
composition-independent — so the floor-2 pad makes solo and co-batched
requests byte-identical. One case is also pinned to the brute-force
``query_ref`` oracle so the whole stack stays semantically grounded, not
just self-consistent.
"""
import pytest

pytest.importorskip("torch")

import threading

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.query import Q
from repro_torch.query.executor import search_bucketed
from repro_torch.query.planner import compile_plan
from repro_torch.serving.retrieval import (MicroBatcher, RetrievalPlan,
                                     RetrievalService, freeze_where,
                                     run_plan)

from torch_query_ref import assert_matches, reference_execute

N = 260
D = 24
K = 8


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    vt = _unit(rng.normal(size=(N, D)).astype(np.float32))
    year = rng.integers(2000, 2030, N).astype(np.int32)
    e = 1500
    src = rng.integers(0, N, e).astype(np.int32)
    dst = rng.integers(0, N, e).astype(np.int32)
    keep = src != dst
    # full probe so the query_ref pin is exact; delta rows on top of the
    # stable build so every sweep covers the stable+delta merge path
    cfg = get_config("hmgi").replace(
        n_partitions=8, n_probe=8, top_k=K, kmeans_iters=6,
        delta_capacity=128, delta_rescore_margin=64)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    ids = np.arange(N, dtype=np.int32)
    idx.ingest({"text": (ids, vt)}, n_nodes=N,
               edges=(src[keep], dst[keep]), node_attrs={"year": year})
    upd = _unit(rng.normal(size=(6, D)).astype(np.float32))
    idx.insert("text", np.arange(6, dtype=np.int32), upd)
    queries = _unit(vt[40:104] + 0.05 * rng.normal(size=(64, D))
                    .astype(np.float32)).astype(np.float32)
    return idx, queries


def _solo(idx, plan, queries):
    """Q sequential (1, k) retrievals through the serving entry."""
    rows = [run_plan(idx, plan, queries[i:i + 1])
            for i in range(queries.shape[0])]
    return (np.concatenate([r[0] for r in rows]),
            np.concatenate([r[1] for r in rows]))


class TestBucketOracle:
    @pytest.mark.parametrize("nq", [1, 2, 3, 4, 7, 8, 16, 32, 33, 64])
    def test_batched_matches_sequential(self, setup, nq):
        idx, queries = setup
        plan = RetrievalPlan(modality="text", k=K)
        bv, bi = run_plan(idx, plan, queries[:nq])
        sv, si = _solo(idx, plan, queries[:nq])
        assert bv.tobytes() == sv.tobytes()
        assert bi.tobytes() == si.tobytes()

    @pytest.mark.parametrize("thresh", [2004, 2027])
    @pytest.mark.parametrize("nq", [1, 3, 8])
    def test_where_both_planner_modes(self, setup, nq, thresh):
        """Low threshold = pushdown, high = oversample — the bucket
        contract must hold in both planner filter modes."""
        idx, queries = setup
        plan = RetrievalPlan(modality="text", k=K,
                             where=freeze_where(("year", "<", thresh)))
        bv, bi = run_plan(idx, plan, queries[:nq])
        sv, si = _solo(idx, plan, queries[:nq])
        assert bv.tobytes() == sv.tobytes()
        assert bi.tobytes() == si.tobytes()

    @pytest.mark.parametrize("nq", [1, 5])
    def test_hybrid_hops(self, setup, nq):
        idx, queries = setup
        plan = RetrievalPlan(modality="text", k=K, n_hops=2)
        bv, bi = run_plan(idx, plan, queries[:nq])
        sv, si = _solo(idx, plan, queries[:nq])
        assert bv.tobytes() == sv.tobytes()
        assert bi.tobytes() == si.tobytes()

    def test_bucketed_matches_query_ref_oracle(self, setup):
        """Semantic grounding: the padded batch is not just internally
        consistent — at full probe it reproduces the brute-force
        reference over the 3-query (pad to 4) bucket."""
        idx, queries = setup
        q3 = queries[:3]
        sv, si = search_bucketed(idx, q3, "text", k=K)
        phys = compile_plan(idx, Q.vector("text", q3).topk(K))
        assert_matches((sv, si), reference_execute(idx, phys))

    def test_mutation_keeps_contract(self, setup):
        """Insert + delete between sweeps: the solo/batched identity is a
        property of the entry, not of one frozen index state."""
        idx, queries = setup
        rng = np.random.default_rng(13)
        plan = RetrievalPlan(modality="text", k=K)
        idx.insert("text", np.arange(10, 13, dtype=np.int32),
                   _unit(rng.normal(size=(3, D)).astype(np.float32)))
        idx.delete("text", np.array([40, 41], dtype=np.int32))
        for nq in (1, 4, 7):
            bv, bi = run_plan(idx, plan, queries[:nq])
            sv, si = _solo(idx, plan, queries[:nq])
            assert bv.tobytes() == sv.tobytes()
            assert bi.tobytes() == si.tobytes()


class TestMicroBatcher:
    def test_concurrent_riders_bit_identical(self, setup):
        """8 threads arriving inside one window must ride >= one shared
        batch and each get exactly its solo-request bytes."""
        idx, queries = setup
        obs.reset()
        plan = RetrievalPlan(modality="text", k=K)
        solo_v, solo_i = _solo(idx, plan, queries[:8])
        mb = MicroBatcher(idx, window_s=0.05, max_batch=64)
        results = [None] * 8
        barrier = threading.Barrier(8)

        def worker(i):
            barrier.wait()
            results[i] = mb.search(plan, queries[i:i + 1])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "micro-batch rider stalled"
        for i in range(8):
            assert results[i][0].tobytes() == solo_v[i:i + 1].tobytes()
            assert results[i][1].tobytes() == solo_i[i:i + 1].tobytes()
        h = obs.histogram("serving.batch_q", obs.COUNT_BUCKETS)
        assert h.count >= 1
        assert h.total / h.count > 1.0, "no cross-request batch formed"

    def test_mixed_plan_batch_falls_back_per_group(self, setup):
        """Two plans in one window: each group runs its own bucketed call
        and every rider still gets its own plan's solo bytes."""
        idx, queries = setup
        obs.reset()
        plans = [RetrievalPlan(modality="text", k=K),
                 RetrievalPlan(modality="text", k=K,
                               where=freeze_where(("year", "<", 2027)))]
        solo = [run_plan(idx, p, queries[i:i + 1])
                for i, p in enumerate(plans * 4)]
        mb = MicroBatcher(idx, window_s=0.05, max_batch=64)
        results = [None] * 8
        barrier = threading.Barrier(8)

        def worker(i):
            barrier.wait()
            results[i] = mb.search(plans[i % 2], queries[i:i + 1])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "mixed-plan rider stalled"
        for i in range(8):
            assert results[i][0].tobytes() == solo[i][0].tobytes()
            assert results[i][1].tobytes() == solo[i][1].tobytes()
        assert obs.counter("serving.batch.mixed_plan").value >= 1

    def test_exact_duplicate_queries_deduped(self, setup):
        """The same query bytes submitted by many threads compute once per
        batch; every rider still gets the full solo bytes."""
        idx, queries = setup
        obs.reset()
        plan = RetrievalPlan(modality="text", k=K)
        sv, si = run_plan(idx, plan, queries[:1])
        mb = MicroBatcher(idx, window_s=0.05, max_batch=64)
        results = [None] * 6
        barrier = threading.Barrier(6)

        def worker(i):
            barrier.wait()
            results[i] = mb.search(plan, queries[:1])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "dedup rider stalled"
        for i in range(6):
            assert results[i][0].tobytes() == sv.tobytes()
            assert results[i][1].tobytes() == si.tobytes()
        assert obs.counter("serving.batch.dedup_hits").value >= 1


class TestRetrievalService:
    def test_batched_and_unbatched_modes_identical(self, setup):
        idx, queries = setup
        plan = RetrievalPlan(modality="text", k=K)
        on = RetrievalService(idx, batching=True, window_s=0.0)
        off = RetrievalService(idx, batching=False)
        a = on.search(plan, queries[0])
        b = off.search(plan, queries[0])
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()

    def test_search_many_matches_solo(self, setup):
        idx, queries = setup
        plan = RetrievalPlan(modality="text", k=K)
        svc = RetrievalService(idx, batching=False)
        got = svc.search_many(plan, queries[:5])
        assert got is not None
        sv, si = _solo(idx, plan, queries[:5])
        assert got[0].tobytes() == sv.tobytes()
        assert got[1].tobytes() == si.tobytes()
