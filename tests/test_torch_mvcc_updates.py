"""Twin of ``tests/test_mvcc_updates.py`` on the port (indexes on the CPU),
all of its cases.

MVCC update-path correctness: latest-version-wins in the delta,
no data loss on repartition or compaction overflow.

These pin two bugs the reference once had:
  1. recency — the delta could hold several live versions of one id
     (insert-then-update before compaction) and score-based dedup returned
     whichever scored higher, i.e. possibly the *stale* vector;
  2. data loss — ``maybe_repartition`` discarded the post-split build's
     overflow mask, and ``compact`` silently truncated overflow beyond the
     fresh delta's capacity.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core import delta as delta_mod
from repro_torch.core import ivf as ivf_mod


def _unit_rows(n, d, rng):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _axis_vec(d, axis):
    v = np.zeros((1, d), np.float32)
    v[0, axis] = 1.0
    return v


def _build(n=400, d=32, **over):
    rng = np.random.default_rng(11)
    v = _unit_rows(n, d, rng)
    over = dict({"delta_capacity": 64}, **over)
    cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=5,
                                     kmeans_iters=4, **over)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n + 64)
    return idx, v


class TestRecency:
    def test_update_never_returns_old_vector(self):
        """insert(id) then insert(id) again: the first (stale) delta version
        must never surface — before or after compaction — even when the
        query is the stale vector itself (where it would score ~1.0)."""
        idx, _ = _build()
        d = 32
        v_old, v_new = _axis_vec(d, 0), _axis_vec(d, 1)
        nid = np.array([450], np.int32)
        idx.insert("text", nid, v_old)
        idx.insert("text", nid, v_new)       # both versions live in the delta

        for stage in ("pre-compaction", "post-compaction"):
            sv, si = idx.search(v_old, "text", k=5)
            for x, s in zip(np.asarray(si)[0], np.asarray(sv)[0]):
                if x == 450:
                    assert s < 0.5, (stage, s)   # stale copy scored ~1.0
            sv, si = idx.search(v_new, "text", k=1)
            assert int(si[0, 0]) == 450 and float(sv[0, 0]) > 0.99, stage
            idx.compact("text")

    def test_update_of_stable_row(self):
        """Updating an ingested row: old stable version superseded, new delta
        version returned, across compaction (the seed's own test, kept here
        with the query aimed at the *old* vector)."""
        idx, v = _build()
        d = 32
        new = _axis_vec(d, 2)
        idx.insert("text", np.array([0], np.int32), new)
        for _ in range(2):
            sv, si = idx.search(v[:1], "text", k=3)   # query = old vector
            for x, s in zip(np.asarray(si)[0], np.asarray(sv)[0]):
                assert x != 0 or s < 0.9, (x, s)
            sv, si = idx.search(new, "text", k=1)
            assert int(si[0, 0]) == 0 and float(sv[0, 0]) > 0.99
            idx.compact("text")

    def test_duplicate_ids_in_one_batch_last_wins(self):
        """One insert batch carrying two versions of an id: the later row
        wins (slot order breaks the version tie)."""
        store = delta_mod.init(16, 8, max_ids=32, device="cpu")
        v = np.zeros((2, 8), np.float32)
        v[0, 0] = 1.0
        v[1, 1] = 1.0
        store = delta_mod.insert(store, torch.as_tensor(v),
                                 torch.tensor([3, 3], dtype=torch.int32))
        dv, di = delta_mod._scan_delta(store, torch.as_tensor(v), k=4)
        di, dv = np.asarray(di), np.asarray(dv)
        # row 0 (stale) must not be visible: querying it returns the later
        # version's (orthogonal) score, not 1.0
        assert di[0, 0] == 3 and dv[0, 0] < 0.5
        assert di[1, 0] == 3 and dv[1, 0] > 0.99
        # and id 3 appears exactly once per query
        for row in di:
            assert (row == 3).sum() == 1

    def test_nsw_refine_respects_mvcc(self):
        """The NSW refine lane must apply the same visibility rules as the
        stable scan: deleted ids don't resurface and updated ids aren't
        ranked by their stale pre-update score."""
        idx, v = _build(use_nsw_refine=True, nsw_degree=8, nsw_ef=32)
        # delete
        idx.delete("text", np.array([5], np.int32))
        _, si = idx.search(v[5:6], "text", k=10)
        assert not np.any(np.asarray(si) == 5)
        # update: query the OLD vector — id 7 may only appear with the new
        # vector's (low) score, never the stale ~1.0 one. Post-compaction the
        # superseded mask is cleared, so the NSW layer must be refreshed too.
        new = _axis_vec(32, 3)
        idx.insert("text", np.array([7], np.int32), new)
        for stage in ("pre-compaction", "post-compaction"):
            sv, si = idx.search(v[7:8], "text", k=10)
            for x, s in zip(np.asarray(si)[0], np.asarray(sv)[0]):
                if x == 7:
                    assert s < 0.9, (stage, s)
            sv, si = idx.search(new, "text", k=1)
            assert int(si[0, 0]) == 7 and float(sv[0, 0]) > 0.99, stage
            idx.compact("text")

    def test_row_versions_stamped(self):
        store = delta_mod.init(8, 4, max_ids=16, device="cpu")
        store = delta_mod.insert(store, torch.ones((2, 4)),
                                 torch.tensor([0, 1], dtype=torch.int32))
        store = delta_mod.insert(store, torch.ones((1, 4)),
                                 torch.tensor([0], dtype=torch.int32))
        rv = np.asarray(store.row_version)
        assert rv[0] == rv[1] == 0 and rv[2] == 1   # batch counter
        assert np.all(rv[3:] == -1)                 # empty slots unstamped
        latest = np.asarray(delta_mod._latest_version_mask(store))
        np.testing.assert_array_equal(latest[:3], [False, True, True])


class TestNoDataLoss:
    def _tight_index(self, n=360, d=24, cap=50, delta_capacity=16):
        """Stable index with per-partition capacity tight enough that
        redistribution overflows."""
        rng = np.random.default_rng(7)
        v = _unit_rows(n, d, rng)
        cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=5,
                                         kmeans_iters=4,
                                         delta_capacity=delta_capacity)
        idx = HMGIIndex(cfg, seed=0, device="cpu")
        idx.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n)
        m = idx.modalities["text"]
        # rebuild at tight capacity, routing build overflow to the delta
        # exactly as ingest does
        stable, overflow = ivf_mod.build(
            m.vectors, m.ids,
            n_partitions=8, bits=8, capacity=cap,
            centroids=m.ivf.centroids)
        m.ivf = stable
        ov = np.where(np.array(overflow))[0]
        if len(ov):
            m.delta = delta_mod.grow(m.delta, int(m.delta.count) + 2 * len(ov))
            m.delta = delta_mod.insert(m.delta, m.vectors[torch.as_tensor(ov)],
                                       m.ids[torch.as_tensor(ov)])
        return idx, v

    def _assert_full_corpus_searchable(self, idx, v):
        """Every vector, queried against itself at full probe, returns its
        own id at rank 1 — nothing dropped anywhere."""
        sv, si = idx.search(v, "text", k=1)
        m = idx.modalities["text"]
        np.testing.assert_array_equal(np.asarray(si)[:, 0], np.asarray(m.ids))

    def test_repartition_preserves_corpus(self):
        idx, v = self._tight_index()
        m = idx.modalities["text"]
        m.workload.hits[:] = 0
        m.workload.hits[int(np.argmax(np.asarray(m.ivf.counts)))] = 10_000
        assert idx.maybe_repartition("text")
        # the fix is only exercised if the split actually overflowed
        stable_rows = int(np.sum(np.asarray(m.ivf.ids) >= 0))
        assert stable_rows < v.shape[0], "test setup: no overflow occurred"
        assert int(m.delta.count) >= v.shape[0] - stable_rows
        self._assert_full_corpus_searchable(idx, v)

    def test_compact_grows_delta_instead_of_truncating(self):
        """Compaction overflow larger than the delta's capacity must grow
        the fresh delta, not silently truncate. cap=40 < n/K guarantees
        ≥ 40 overflow rows at build time against a 16-slot delta."""
        idx, v = self._tight_index(cap=40, delta_capacity=16)
        m = idx.modalities["text"]
        overflowed = v.shape[0] - int(np.sum(np.asarray(m.ivf.ids) >= 0))
        assert overflowed > 16, "test setup: overflow must exceed delta cap"
        idx.compact("text")
        m = idx.modalities["text"]
        assert int(m.delta.count) >= overflowed - 16  # nothing truncated
        assert not delta_mod.should_compact(m.delta, idx.cfg.compact_threshold)
        self._assert_full_corpus_searchable(idx, v)

    def test_delete_not_resurrected_by_repartition(self):
        idx, v = self._tight_index()
        m = idx.modalities["text"]
        victim = np.array([5], np.int32)
        idx.delete("text", victim)
        m.workload.hits[:] = 0
        m.workload.hits[int(np.argmax(np.asarray(m.ivf.counts)))] = 10_000
        assert idx.maybe_repartition("text")
        sv, si = idx.search(v[5:6], "text", k=10)
        assert not np.any(np.asarray(si) == 5)

    def test_insert_beyond_delta_capacity_not_dropped(self):
        """A burst of inserts larger than the delta's free space must stay
        searchable (compact-then-grow, never a silent drop)."""
        idx, v = _build(delta_capacity=16)
        rng = np.random.default_rng(13)
        burst = _unit_rows(40, 32, rng)
        ids = np.arange(410, 450, dtype=np.int32)
        idx.insert("text", ids, burst)
        sv, si = idx.search(burst, "text", k=1)
        np.testing.assert_array_equal(np.asarray(si)[:, 0], ids)
