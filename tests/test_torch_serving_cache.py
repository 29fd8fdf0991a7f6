"""Twin of ``tests/test_serving_cache.py`` on the port (indexes on the CPU).

Hot-result cache contract: a hit is bit-identical to the compute it
replaced; every result-affecting index mutation (insert, delete, applied
maintenance, compaction) bumps the version stamp and forces a miss whose
fresh result matches the brute-force ``query_ref`` oracle; a no-op
maintenance pass must NOT bump (the MaintenanceDriver ticks constantly —
flushing the cache on every idle tick would make it useless); eviction is
LRU-ordered; signature collisions (same fp16 key, different fp32 bytes)
miss instead of serving a nearby query's results.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.query import Q
from repro_torch.query.planner import compile_plan
from repro_torch.serving.cache import HotResultCache, query_signature
from repro_torch.serving.retrieval import RetrievalPlan, RetrievalService

from torch_query_ref import assert_matches, reference_execute

N = 220
D = 16
K = 6


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture()
def setup():
    rng = np.random.default_rng(3)
    vt = _unit(rng.normal(size=(N, D)).astype(np.float32))
    cfg = get_config("hmgi").replace(
        n_partitions=6, n_probe=6, top_k=K, kmeans_iters=5,
        delta_capacity=128, delta_rescore_margin=64)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({"text": (np.arange(N, dtype=np.int32), vt)}, n_nodes=N)
    queries = _unit(vt[10:26] + 0.05 * rng.normal(size=(16, D))
                    .astype(np.float32)).astype(np.float32)
    cache = HotResultCache(capacity=32)
    svc = RetrievalService(idx, batching=False, cache=cache)
    plan = RetrievalPlan(modality="text", k=K)
    return idx, svc, cache, plan, queries, rng


def _counter(name):
    return obs.counter(name).value


class TestHitPath:
    def test_hit_is_bit_identical(self, setup):
        idx, svc, cache, plan, queries, _ = setup
        first = svc.search(plan, queries[0])
        h0 = _counter("serving.cache.hit")
        second = svc.search(plan, queries[0])
        assert _counter("serving.cache.hit") == h0 + 1
        assert second[0].tobytes() == first[0].tobytes()
        assert second[1].tobytes() == first[1].tobytes()

    def test_signature_collision_misses(self, setup):
        """Two fp32 queries that round to the same fp16 signature must
        NOT share an entry — the exact-byte check turns the collision
        into a miss and leaves the resident owner in place."""
        idx, svc, cache, plan, queries, _ = setup
        q1 = np.ones((1, D), np.float32)
        q2 = q1 + np.float32(1e-4)       # fp16 resolution near 1.0 ~ 1e-3
        assert query_signature(q1) == query_signature(q2)
        assert q1.tobytes() != q2.tobytes()
        r1 = svc.search(plan, q1)
        version = idx.version
        c0 = _counter("serving.cache.collision")
        # a raw lookup with the colliding query misses without disturbing
        # the resident owner
        assert cache.lookup(plan, q2, version) is None
        assert _counter("serving.cache.collision") == c0 + 1
        hit = cache.lookup(plan, q1, version)
        assert hit is not None and hit[1].tobytes() == r1[1].tobytes()
        # through the service, the colliding miss recomputes and its store
        # takes over the shared key (last writer wins); q1 then collides
        # against q2's entry — still never served the wrong bytes
        r2 = svc.search(plan, q2)
        assert r2[1].tobytes() != b"" and r2 is not None
        assert cache.lookup(plan, q2, version) is not None
        assert cache.lookup(plan, q1, version) is None
        # three collisions total: the raw q2 probe, the service's q2
        # lookup before it recomputed, and the final q1 probe
        assert _counter("serving.cache.collision") == c0 + 3


class TestVersionInvalidation:
    def _assert_miss_then_oracle(self, idx, svc, plan, q, v_before):
        assert idx.version > v_before, "mutation did not bump the version"
        i0 = _counter("serving.cache.invalidated")
        fresh = svc.search(plan, q)
        assert _counter("serving.cache.invalidated") == i0 + 1
        phys = compile_plan(idx, Q.vector("text", q.reshape(1, -1)).topk(K))
        assert_matches(fresh, reference_execute(idx, phys))

    def test_insert_invalidates(self, setup):
        idx, svc, cache, plan, queries, rng = setup
        svc.search(plan, queries[0])
        v0 = idx.version
        idx.insert("text", np.arange(N, N + 3, dtype=np.int32),
                   _unit(rng.normal(size=(3, D)).astype(np.float32)))
        self._assert_miss_then_oracle(idx, svc, plan, queries[0], v0)

    def test_delete_invalidates(self, setup):
        idx, svc, cache, plan, queries, _ = setup
        svc.search(plan, queries[1])
        v0 = idx.version
        idx.delete("text", np.array([10, 11], dtype=np.int32))
        self._assert_miss_then_oracle(idx, svc, plan, queries[1], v0)

    def test_applied_maintenance_invalidates(self, setup):
        idx, svc, cache, plan, queries, rng = setup
        idx.insert("text", np.arange(0, 48, dtype=np.int32),
                   _unit(rng.normal(size=(48, D)).astype(np.float32)))
        svc.search(plan, queries[2])
        v0 = idx.version
        # need_rows forces the planner to apply drain work this pass (the
        # insert path's never-drop-a-write hook) — an *applied* trail must
        # bump, unlike the idle pass below
        idx.maintain("text", need_rows=32)
        self._assert_miss_then_oracle(idx, svc, plan, queries[2], v0)

    def test_compaction_invalidates(self, setup):
        idx, svc, cache, plan, queries, rng = setup
        idx.insert("text", np.arange(0, 8, dtype=np.int32),
                   _unit(rng.normal(size=(8, D)).astype(np.float32)))
        svc.search(plan, queries[3])
        v0 = idx.version
        idx.compact("text")
        self._assert_miss_then_oracle(idx, svc, plan, queries[3], v0)

    def test_noop_maintenance_does_not_invalidate(self, setup):
        """Run maintenance until it stops changing the index, then one
        more pass: the version must hold and a cached entry must still
        hit — the idle MaintenanceDriver tick must not flush the cache."""
        idx, svc, cache, plan, queries, _ = setup
        for _ in range(8):
            v = idx.version
            idx.maintain("text")
            if idx.version == v:
                break
        svc.search(plan, queries[4])
        v0 = idx.version
        idx.maintain("text")
        assert idx.version == v0, "no-op maintain bumped the version"
        h0 = _counter("serving.cache.hit")
        svc.search(plan, queries[4])
        assert _counter("serving.cache.hit") == h0 + 1


class TestLRU:
    def test_eviction_is_lru_ordered(self):
        cache = HotResultCache(capacity=3)
        qs = [np.full((1, 4), float(i), np.float32) for i in range(4)]
        out = (np.zeros((1, 2), np.float32), np.zeros((1, 2), np.int64))
        for i in range(3):
            cache.store("p", qs[i], 0, *out)
        # touch q0 so q1 becomes the LRU victim
        assert cache.lookup("p", qs[0], 0) is not None
        cache.store("p", qs[3], 0, *out)
        assert len(cache) == 3
        assert cache.lookup("p", qs[1], 0) is None      # evicted
        assert cache.lookup("p", qs[0], 0) is not None  # survived the touch
        keys = cache.keys()
        assert keys[0] == ("p", query_signature(qs[2]))  # oldest first

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            HotResultCache(capacity=0)

    def test_clear(self):
        cache = HotResultCache(capacity=2)
        q = np.ones((1, 4), np.float32)
        cache.store("p", q, 0, np.zeros((1, 2), np.float32),
                    np.zeros((1, 2), np.int64))
        assert len(cache) == 1
        cache.clear()
        assert len(cache) == 0
        assert cache.lookup("p", q, 0) is None
