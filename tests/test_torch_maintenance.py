"""Twin of ``tests/test_maintenance.py`` on the port, plus parity with the
JAX package.

The twin cases are the reference's, on a port index built on the CPU (its
own K-means seeding, so its own layout), against the port's oracle
``torch_query_ref``. They cover every reference case.

The parity cases build the reference index, apply the same writes there,
carry its state into the port with ``convert.index_from_jax_state`` (the
slab, the delta's int8 bytes and the partition statistics are then the
reference's), and run the same ``maintain`` / executor calls on both.
Tolerances:

- byte moves (drains, merges, splits) leave the slab's ``data`` / ``vmin``
  / ``scale`` / ``ids`` / ``counts``, the delta (every field) and the
  integer and boolean statistics (``dead``, ``drift_cnt``, ``parked``)
  byte-equal, as are the centroids a merge parks and those a split's K=2
  fit makes from the reference's seed rows (both packages sum each
  cluster in row order);
- a recluster's centroid (a column mean, which torch sums pairwise and
  XLA in another order) and the float statistics (``baseline``,
  ``drift_sum``) agree to 1e-5 absolute;
- a delta row a merge overflows is quantized by each package (the
  reference inside ``jax.jit``): codes within one level, as in
  ``test_torch_ivf_delta._same_delta``;
- reports are equal strings; scores agree to 1e-5, ids exactly where
  scores are distinct (``assert_topk_match``).
"""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core.cost_model import (MaintenanceSummary,
                                         plan_maintenance)
from repro_torch.core.partitioner import parked_mask
from repro_torch.maintenance import executor as maint_exec
from repro_torch.query import Q
from repro_torch.query.planner import compile_plan
from repro_torch.serving.scheduler import MaintenanceDriver

from torch_query_ref import assert_matches, reference_execute


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _build(n=400, d=32, seed=0, **over):
    rng = np.random.default_rng(seed + 11)
    v = _unit(rng.normal(size=(n, d)).astype(np.float32))
    over = dict({"delta_capacity": 64, "delta_rescore_margin": 64}, **over)
    cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=5,
                                     kmeans_iters=4, **over)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n + 100)
    return idx, v


def _oracle_check(idx, q, k=5, n_probe=8):
    """Full-probe exactness vs the brute-force reference interpreter."""
    plan = Q.vector("text", q, n_probe=n_probe).topk(k)
    phys = compile_plan(idx, plan)
    assert_matches(idx.query(plan), reference_execute(idx, phys))


class TestNoop:
    def test_empty_delta_maintain_is_noop(self):
        idx, v = _build()
        m = idx.modalities["text"]
        before = (np.asarray(m.ivf.data).copy(), np.asarray(m.ivf.ids).copy(),
                  np.asarray(m.ivf.centroids).copy(), int(m.delta.count))
        report = idx.maintain("text")
        assert report.is_noop and report.describe() == "text: noop"
        np.testing.assert_array_equal(np.asarray(m.ivf.data), before[0])
        np.testing.assert_array_equal(np.asarray(m.ivf.ids), before[1])
        np.testing.assert_array_equal(np.asarray(m.ivf.centroids), before[2])
        assert int(m.delta.count) == before[3]

    def test_plan_maintenance_noop_below_thresholds(self):
        K, cap = 8, 64
        s = MaintenanceSummary(
            live=np.full(K, 40), free=np.full(K, 24),
            heat=np.full(K, 10), dead=np.zeros(K, np.int64),
            drift=np.zeros(K), parked=np.zeros(K, bool),
            delta_live=3, delta_used=3, delta_capacity=64, cap=cap)
        assert plan_maintenance(s, budget_rows=1024, chunk=64) == []


class TestPolicy:
    def _summary(self, **over):
        K, cap = 8, 64
        base = dict(live=np.full(K, 40), free=np.full(K, 24),
                    heat=np.full(K, 10), dead=np.zeros(K, np.int64),
                    drift=np.zeros(K), parked=np.zeros(K, bool),
                    delta_live=3, delta_used=3, delta_capacity=64, cap=cap)
        base.update(over)
        return MaintenanceSummary(**base)

    def test_delta_pressure_emits_chunks_within_budget(self):
        s = self._summary(delta_live=48, delta_used=48)
        acts = plan_maintenance(s, budget_rows=32, chunk=16)
        assert [a.kind for a in acts] == ["compact_chunk", "compact_chunk"]
        assert sum(a.rows for a in acts) <= 32

    def test_need_rows_forces_drain_regardless_of_pressure(self):
        s = self._summary(delta_live=4, delta_used=10)
        acts = plan_maintenance(s, budget_rows=8, chunk=16, need_rows=10)
        assert acts and all(a.kind == "compact_chunk" for a in acts)
        assert sum(a.rows for a in acts) >= 10

    def test_hollow_partition_plans_merge(self):
        live = np.full(8, 40)
        live[3] = 2                       # hollowed out
        dead = np.zeros(8, np.int64)
        dead[3] = 38
        s = self._summary(live=live, dead=dead)
        acts = plan_maintenance(s, budget_rows=1024, chunk=64)
        assert any(a.kind == "merge_cold" and a.partition == 3 for a in acts)

    def test_heat_skew_plans_split_with_enabling_merge(self):
        heat = np.full(8, 2)
        heat[5] = 1000
        live = np.full(8, 60)
        live[2] = 5
        s = self._summary(heat=heat, live=live)
        acts = plan_maintenance(s, budget_rows=1024, chunk=64)
        kinds = [a.kind for a in acts]
        assert "split_hot" in kinds
        # no parked slot: the enabling merge must come before the split
        assert "merge_cold" in kinds
        assert kinds.index("merge_cold") < kinds.index("split_hot")

    def test_drift_plans_recluster(self):
        drift = np.zeros(8)
        drift[1] = 0.8
        s = self._summary(drift=drift)
        acts = plan_maintenance(s, budget_rows=1024, chunk=64)
        assert [(a.kind, a.partition) for a in acts] == [("recluster", 1)]


class TestIncrementalCompact:
    def test_drain_matches_full_compact(self):
        """The same pure-insert stream, drained in chunks vs one full
        compact, must end in the same searchable state: identical
        partition membership, scores equal to within one int8 quantization
        step (the two paths quantize the same vectors under different
        batch shapes, and XLA fusion may flip the last rounding bit — the
        drain moves the delta's stored bytes, the rebuild re-quantizes).
        With interleaved updates/deletes the two paths may additionally
        differ in *placement* — which rows overflow to the fp32 delta —
        and each is then pinned to its own oracle by
        TestInterleavedOracle instead."""
        streams = []
        for _ in range(2):
            idx, v = _build(maint_auto=False, delta_capacity=256)
            rng = np.random.default_rng(3)
            ids = np.arange(450, 510, dtype=np.int32)       # brand-new ids
            vecs = rng.normal(size=(60, 32)).astype(np.float32)
            idx.insert("text", ids, vecs)
            streams.append((idx, v))
        (a, v), (b, _) = streams
        # a: incremental chunks to empty (need_rows forces drains past the
        # pressure threshold, 32 rows of bounded work per call); b: one
        # full compact
        while int(a.modalities["text"].delta.count):
            r = a.maintain("text", budget=32, need_rows=32)
            if all(res.get("drained", 0) == 0 and not res.get("reclaimed", 0)
                   for _, res in r.actions) or r.is_noop:
                break
        b.compact("text")
        assert int(a.modalities["text"].delta.count) == 0
        ma, mb = a.modalities["text"], b.modalities["text"]
        # identical placement: every partition holds the same id set
        ia_slab, ib_slab = np.asarray(ma.ivf.ids), np.asarray(mb.ivf.ids)
        for p in range(ma.ivf.n_partitions):
            assert (set(ia_slab[p][ia_slab[p] >= 0])
                    == set(ib_slab[p][ib_slab[p] >= 0])), p
        q = _unit(np.random.default_rng(5).normal(size=(16, 32))
                  .astype(np.float32))
        sa, ia = a.search(q, "text", k=8)
        sb, ib = b.search(q, "text", k=8)
        # one int8 step of a unit-norm row ≈ 2/255 per element: scores
        # agree to well under that
        np.testing.assert_allclose(np.asarray(sa), np.asarray(sb),
                                   rtol=0, atol=5e-3)

    def test_update_drain_clears_superseded_and_serves_latest(self):
        """An updated id drained incrementally must overwrite its stable
        slot: the pre-update vector never resurfaces, the superseded bit
        clears, and the new version serves from stable."""
        idx, v = _build(maint_auto=False)
        d = 32
        new = np.zeros((1, d), np.float32)
        new[0, 1] = 1.0
        idx.insert("text", np.array([0], np.int32), new)
        m = idx.modalities["text"]
        assert bool(np.asarray(m.delta.superseded)[0])
        idx.maintain("text", budget=4096, need_rows=1)   # force past pressure
        assert int(m.delta.count) == 0
        assert not bool(np.asarray(m.delta.superseded)[0])
        sv, si = idx.search(new, "text", k=1)
        assert int(si[0, 0]) == 0 and float(sv[0, 0]) > 0.99
        sv, si = idx.search(v[:1], "text", k=5)   # query the OLD vector
        for x, s in zip(np.asarray(si)[0], np.asarray(sv)[0]):
            assert x != 0 or s < 0.9, (x, s)

    def test_forced_drain_during_update_insert_keeps_one_version(self):
        """Regression: an insert that forces a mid-call drain (batch larger
        than the delta's free slots) while carrying an update must not end
        with two visible versions. The drain must run BEFORE the batch's
        supersede bookkeeping — draining after it would move the id's old
        delta version into stable and clear its superseded bit, then append
        the new version: both visible, the stale one served from stable."""
        idx, v = _build(delta_capacity=64)          # maint_auto on
        d = 32
        v1, v2 = np.zeros((1, d), np.float32), np.zeros((1, d), np.float32)
        v1[0, 3] = 1.0
        v2[0, 4] = 1.0
        idx.insert("text", np.array([0], np.int32), v1)   # update, in delta
        # batch > free slots forces a drain inside this insert; it carries
        # the next update of the same id
        rng = np.random.default_rng(21)
        big = np.concatenate([v2, rng.normal(size=(70, d)).astype(np.float32)])
        ids = np.concatenate([[0], np.arange(451, 521)]).astype(np.int32)
        idx.insert("text", ids, big)
        sv, si = idx.search(v1, "text", k=5)        # query the OLD vector
        for x, s in zip(np.asarray(si)[0], np.asarray(sv)[0]):
            assert x != 0 or s < 0.9, (x, s)
        sv, si = idx.search(v2, "text", k=1)
        assert int(si[0, 0]) == 0 and float(sv[0, 0]) > 0.99
        _oracle_check(idx, _unit(rng.normal(size=(4, d)).astype(np.float32)))

    @pytest.mark.parametrize("bits", [4, 16])
    def test_drain_requantizes_non_int8_slabs(self, bits):
        """Regression: the delta's int8 mirror only matches an int8 slab's
        layout — draining into a 4/16-bit slab must re-quantize the fp32
        master rows at the slab's width (byte-moving int8 codes would crash
        on the packed layout or corrupt bf16 scores)."""
        idx, v = _build(maint_auto=False, quant_bits=bits)
        assert idx.modalities["text"].ivf.bits == bits
        rng = np.random.default_rng(23)
        burst = _unit(rng.normal(size=(24, 32)).astype(np.float32))
        ids = np.arange(451, 475, dtype=np.int32)
        idx.insert("text", ids, burst)
        idx.maintain("text", budget=4096, need_rows=24)
        assert int(idx.modalities["text"].delta.count) == 0
        sv, si = idx.search(burst, "text", k=1, n_probe=8)
        np.testing.assert_array_equal(np.asarray(si)[:, 0], ids)
        assert float(np.asarray(sv).min()) > 0.9    # sane dequantized scores

    def test_full_partitions_keep_rows_in_delta(self):
        """Rows whose partition has no free slot must survive in the delta
        (searchable), not vanish — the never-drop-a-write invariant under
        bounded drains."""
        idx, v = _build(maint_auto=False, delta_capacity=512)
        m = idx.modalities["text"]
        # burst big enough that some partitions run out of slots
        rng = np.random.default_rng(9)
        burst = _unit(rng.normal(size=(300, 32)).astype(np.float32))
        ids = np.arange(450, 750, dtype=np.int32) % 500    # some updates too
        ids = np.arange(450, 750, dtype=np.int32)
        ids = np.clip(ids, 0, 499)
        idx.insert("text", ids, burst)
        idx.maintain("text", budget=100_000)
        uniq, last = np.unique(ids[::-1], return_index=True)
        sv, si = idx.search(burst[::-1][last], "text", k=1)
        np.testing.assert_array_equal(np.asarray(si)[:, 0], uniq)


    def test_cleared_superseded_counts_slotless_ids(self):
        """Regression: an updated id with no stable slot (it entered via
        the delta) still clears a superseded bit on drain — the count the
        facade's NSW-refresh decision keys on must include it."""
        idx, v = _build(maint_auto=False)
        d = 32
        rng = np.random.default_rng(31)
        nid = np.array([460], np.int32)              # brand-new id
        idx.insert("text", nid, rng.normal(size=(1, d)).astype(np.float32))
        idx.insert("text", nid, rng.normal(size=(1, d)).astype(np.float32))
        m = idx.modalities["text"]
        assert bool(np.asarray(m.delta.superseded)[460])
        report = idx.maintain("text", budget=4096, need_rows=1)
        cleared = sum(r.get("cleared_superseded", 0)
                      for _, r in report.actions)
        assert cleared >= 1
        assert not bool(np.asarray(m.delta.superseded)[460])

    def test_dead_watermark_reclaimed_under_pressure(self):
        """Regression: insert-then-delete-everything leaves a delta full of
        dead weight (live=0, watermark high); an explicit maintain must
        reclaim the slots instead of reporting noop."""
        # pressure below the (synchronous) compact threshold, so the batch
        # itself stays in the delta but still qualifies for maintenance
        idx, v = _build(maint_auto=False, delta_capacity=128,
                        maint_delta_pressure=0.3)
        rng = np.random.default_rng(33)
        ids = np.arange(451, 499, dtype=np.int32)
        idx.insert("text", ids, rng.normal(size=(48, 32)).astype(np.float32))
        idx.delete("text", ids)
        m = idx.modalities["text"]
        assert int(m.delta.count) == 48
        report = idx.maintain("text")
        assert not report.is_noop
        assert int(m.delta.count) == 0
        _, si = idx.search(v[:4], "text", k=10, n_probe=8)
        assert not np.any(np.isin(np.asarray(si), ids))

    def test_budget_zero_is_noop(self):
        """An explicit budget=0 means no optional work — not the default."""
        idx, _ = _build(maint_auto=False, delta_capacity=128,
                        maint_delta_pressure=0.3)
        rng = np.random.default_rng(35)
        idx.insert("text", np.arange(451, 499, dtype=np.int32),
                   rng.normal(size=(48, 32)).astype(np.float32))
        m = idx.modalities["text"]
        before = int(m.delta.count)
        assert before >= 48                  # over pressure, would drain
        assert idx.maintain("text", budget=0).is_noop
        assert int(m.delta.count) == before


class TestMergeCold:
    def test_all_tombstone_partition_merges_away(self):
        idx, v = _build(maint_auto=False)
        m = idx.modalities["text"]
        counts = np.asarray(m.ivf.counts)
        p = int(np.argmin(counts))
        pids = np.asarray(m.ivf.ids[p])
        pids = pids[pids >= 0]
        idx.delete("text", pids)
        report = idx.maintain("text", budget=100_000)
        assert any(a.kind == "merge_cold" and a.partition == p
                   for a, _ in report.actions), report.describe()
        assert parked_mask(np.asarray(m.ivf.centroids))[p]
        assert not np.any(np.asarray(m.ivf.ids[p]) >= 0)
        # deleted ids never resurface — query their own vectors at full probe
        sel = np.isin(np.arange(len(v)), pids)
        _, si = idx.search(v[sel], "text", k=10, n_probe=8)
        assert not np.any(np.isin(np.asarray(si), pids))
        # and the survivors are all still there
        _, si = idx.search(v[~sel], "text", k=1, n_probe=8)
        np.testing.assert_array_equal(np.asarray(si)[:, 0],
                                      np.arange(len(v))[~sel])
        # probe widths clamp to the live partition count
        assert "probe=7" in idx.explain(Q.vector("text", v[:2]).topk(5))

    def test_merge_overflow_routes_to_delta(self):
        """A merge whose sibling lacks room must push survivors to the
        delta, never drop them."""
        idx, v = _build(maint_auto=False)
        m = idx.modalities["text"]
        counts = np.asarray(m.ivf.counts)
        p = int(np.argmax(counts))          # merging the FULLEST overflows
        before = int(m.delta.count)
        res = maint_exec.merge_cold(m, m.stats, p)
        assert res["ivf_changed"]
        assert res["overflow"] == int(m.delta.count) - before
        _, si = idx.search(v, "text", k=1, n_probe=8)
        np.testing.assert_array_equal(np.asarray(si)[:, 0], np.arange(len(v)))


class TestRecluster:
    def test_results_unchanged_at_full_probe(self):
        idx, v = _build(maint_auto=False)
        m = idx.modalities["text"]
        q = _unit(np.random.default_rng(4).normal(size=(12, 32))
                  .astype(np.float32))
        s0, i0 = idx.search(q, "text", k=8, n_probe=8)
        # inject drift so every live partition re-centers
        m.stats.baseline[:] = 1e-3
        m.stats.drift_sum[:] = 10.0
        m.stats.drift_cnt[:] = 100
        report = idx.maintain("text", budget=100_000)
        assert any(a.kind == "recluster" for a, _ in report.actions)
        s1, i1 = idx.search(q, "text", k=8, n_probe=8)
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        # accumulators re-anchored: no immediate re-trigger
        assert idx.maintain("text").is_noop


class TestInterleavedOracle:
    def test_stream_matches_reference_interpreter(self):
        """The acceptance bar: inserts, updates, deletes, searches and
        maintenance interleaved — after every step the engine matches the
        brute-force oracle at full probe (stable+delta, MVCC-visible)."""
        idx, v = _build(delta_capacity=128, maint_chunk=32,
                        maint_budget_rows=64)
        n, d = len(v), 32
        rng = np.random.default_rng(17)
        q = _unit(rng.normal(size=(6, d)).astype(np.float32))
        for step in range(8):
            ids = rng.integers(0, n + 80, 24).astype(np.int32)  # mix of
            vecs = rng.normal(size=(24, d)).astype(np.float32)  # new+update
            idx.insert("text", ids, vecs)
            idx.delete("text", rng.integers(0, n, 4).astype(np.int32))
            if step % 2:
                idx.maintain("text", budget=48)
            _oracle_check(idx, q)
        # drain everything and check once more
        idx.maintain("text", budget=100_000)
        _oracle_check(idx, q)


class TestWiring:
    def test_maintain_invalidates_sharded_replica(self):
        idx, v = _build(maint_auto=False)
        m = idx.modalities["text"]
        rng = np.random.default_rng(2)
        # sub-threshold batch: stays in the delta until maintain drains it
        idx.insert("text", np.arange(450, 470, dtype=np.int32),
                   rng.normal(size=(20, 32)).astype(np.float32))
        assert int(m.delta.count) == 20
        m.ivf_sharded = "stale-sentinel"
        report = idx.maintain("text", budget=4096, need_rows=1)
        assert not report.is_noop
        assert m.ivf_sharded is None

    def test_auto_trigger_drains_on_insert(self):
        idx, v = _build(delta_capacity=64)       # maint_auto default True
        rng = np.random.default_rng(8)
        for i in range(4):
            idx.insert("text", np.arange(450 + 40 * i, 490 + 40 * i,
                                         dtype=np.int32),
                       rng.normal(size=(40, 32)).astype(np.float32))
        m = idx.modalities["text"]
        # the watermark stays below capacity: drains kept pace with ingest
        assert int(m.delta.count) < 64
        assert "maintenance" in idx.metrics()

    def test_repartition_ignores_parked_partition_heat(self):
        """Regression: a merged-away partition keeps its accumulated probe
        hits (merge never resets heat); maybe_repartition must not let that
        stale heat win the hot-argmax and suppress the real split."""
        idx, v = _build(maint_auto=False)
        m = idx.modalities["text"]
        p = int(np.argmin(np.asarray(m.ivf.counts)))
        res = maint_exec.merge_cold(m, m.stats, p)
        assert res["ivf_changed"] and m.stats.parked[p]
        m.workload.hits[:] = 0
        m.workload.hits[p] = 50_000          # stale heat on the parked slot
        live_hot = int(np.argmax(np.asarray(m.ivf.counts)))
        m.workload.hits[live_hot] = 10_000
        assert idx.maybe_repartition("text")  # splits the live hot one
        _, si = idx.search(v, "text", k=1, n_probe=8)
        np.testing.assert_array_equal(np.asarray(si)[:, 0], np.arange(len(v)))

    def test_maintenance_driver_paces_runs(self):
        idx, _ = _build()
        drv = MaintenanceDriver(idx, budget_rows=64, interval=3)
        reports = [drv.tick() for _ in range(9)]
        assert drv.runs == 3
        assert sum(r is not None for r in reports) == 3

    def test_maintain_all_modalities_returns_dict(self):
        idx, _ = _build()
        out = idx.maintain()
        assert set(out) == {"text"} and out["text"].is_noop


# ------------------------------------------------ parity with the reference
import dataclasses

import jax
import torch

from repro.configs import get_config as jget_config
from repro.core import HMGIIndex as JIndex
from repro.maintenance import executor as jexec
from repro_torch.configs.base import HMGIConfig
from repro_torch.convert import index_from_jax_state
from test_torch_ivf_topk import assert_topk_match

_FIT_ATOL = 1e-5


def _ref_index(n=400, d=32, seed=0, **over):
    """The reference twin of ``_build`` (maint_auto off: writes before the
    carry-over must not maintain on their own)."""
    rng = np.random.default_rng(seed + 11)
    v = _unit(rng.normal(size=(n, d)).astype(np.float32))
    over = dict({"delta_capacity": 64, "delta_rescore_margin": 64,
                 "maint_auto": False}, **over)
    cfg = jget_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=5,
                                      kmeans_iters=4, **over)
    ji = JIndex(cfg, seed=0)
    ji.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n_nodes=n + 100)
    return ji, v


def _carry(ji):
    tree, meta = ji.state_tree()
    tree = {k: np.asarray(x) for k, x in tree.items()}
    return index_from_jax_state(tree, meta, "cpu",
                                cfg=HMGIConfig(**dataclasses.asdict(ji.cfg)))


def _writes(ji, seed=3, n_new=30, n_upd=20, n_del=12):
    """New ids, updates of stable ids and deletes, applied to the
    reference before the carry-over."""
    rng = np.random.default_rng(seed)
    d = ji.modalities["text"].vectors.shape[1]
    ids = np.concatenate([np.arange(450, 450 + n_new),
                          rng.choice(400, n_upd, replace=False)])
    ji.insert("text", ids.astype(np.int32),
              rng.normal(size=(ids.size, d)).astype(np.float32))
    ji.delete("text", rng.choice(400, n_del, replace=False).astype(np.int32))


def _same_state(ji, pi, *, centroids_exact=True, delta_code_tol=0):
    jm, pm = ji.modalities["text"], pi.modalities["text"]
    for f in ("data", "vmin", "scale", "ids", "counts"):
        got, want = getattr(pm.ivf, f), np.asarray(getattr(jm.ivf, f))
        if got.dtype == torch.bfloat16:         # compare the bf16 bits
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, f)
    pc, jc = pm.ivf.centroids.numpy(), np.asarray(jm.ivf.centroids)
    if centroids_exact:
        np.testing.assert_array_equal(pc, jc)
    else:
        np.testing.assert_allclose(pc, jc, rtol=0, atol=_FIT_ATOL)
        np.testing.assert_array_equal(parked_mask(pc), parked_mask(jc))
    for f in jm.delta._fields:
        got, want = getattr(pm.delta, f).numpy(), np.asarray(getattr(jm.delta, f))
        if f == "qdata" and delta_code_tol:
            assert np.abs(got.astype(int) - want.astype(int)).max() \
                <= delta_code_tol
        elif f == "qscale" and delta_code_tol:
            np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, want, f)
    np.testing.assert_array_equal(pm.vectors.numpy(), np.asarray(jm.vectors))
    np.testing.assert_array_equal(pm.ids.numpy(), np.asarray(jm.ids))
    for f in ("dead", "drift_cnt", "parked"):
        np.testing.assert_array_equal(getattr(pm.stats, f),
                                      getattr(jm.stats, f), f)
    for f in ("baseline", "drift_sum"):
        np.testing.assert_allclose(getattr(pm.stats, f),
                                   getattr(jm.stats, f), rtol=0,
                                   atol=_FIT_ATOL)
    assert pm.stats.max_ids == jm.stats.max_ids


def _same_results(ji, pi, v, seed=5):
    rng = np.random.default_rng(seed)
    q = np.concatenate([v[:8] + 0.05 * rng.normal(size=(8, v.shape[1])),
                        rng.normal(size=(8, v.shape[1]))]).astype(np.float32)
    for n_probe in (3, 8):
        assert_topk_match(ji.search(q, "text", k=8, n_probe=n_probe),
                          pi.search(q, "text", k=8, n_probe=n_probe))


def _maintain_both(ji, pi, **kw):
    rj, rp = ji.maintain("text", **kw), pi.maintain("text", **kw)
    assert rp.describe() == rj.describe()
    assert ([dataclasses.astuple(a) for a, _ in rp.actions]
            == [dataclasses.astuple(a) for a, _ in rj.actions])
    return rp


class TestParity:
    def test_carry_over_keeps_the_statistics(self):
        ji, _ = _ref_index()
        _writes(ji)
        pi = _carry(ji)
        _same_state(ji, pi)
        tree, meta = pi.state_tree()
        assert meta["modalities"]["text"]["stats"]
        assert tree["m/text/stats/dead"].dtype == np.int64

    def test_drains_match_reference(self):
        """Bounded drains of new rows and updates (each row placed by its
        current assignment, an update's old slot cleared or overwritten)
        until the delta is empty: byte-equal after every pass."""
        ji, v = _ref_index(delta_capacity=128, maint_chunk=16)
        _writes(ji)
        pi = _carry(ji)
        for _ in range(8):
            rep = _maintain_both(ji, pi, budget=16, need_rows=16)
            _same_state(ji, pi)
            if not int(pi.modalities["text"].delta.count) or rep.is_noop:
                break
        assert int(pi.modalities["text"].delta.count) == 0
        _same_results(ji, pi, v)

    @pytest.mark.parametrize("bits", [4, 16])
    def test_requantizing_drain_matches_reference(self, bits):
        ji, v = _ref_index(quant_bits=bits)
        _writes(ji, n_upd=0, n_del=0, n_new=24)
        pi = _carry(ji)
        _maintain_both(ji, pi, budget=4096, need_rows=24)
        _same_state(ji, pi)
        _same_results(ji, pi, v)

    def test_merge_cold_matches_reference(self):
        """Deleting most of the emptiest partition plans a merge: survivors
        move byte-identically to the nearest sibling, the partition
        parks."""
        ji, v = _ref_index()
        jm = ji.modalities["text"]
        p = int(np.argmin(np.asarray(jm.ivf.counts)))
        pids = np.asarray(jm.ivf.ids[p])
        pids = pids[pids >= 0]
        ji.delete("text", pids[: max(1, (9 * pids.size) // 10)])
        pi = _carry(ji)
        rep = _maintain_both(ji, pi, budget=100_000)
        assert any(a.kind == "merge_cold" and a.partition == p
                   for a, _ in rep.actions), rep.describe()
        _same_state(ji, pi)
        _same_results(ji, pi, v)

    def test_merge_overflow_matches_reference(self):
        """Merging the fullest partition overflows the sibling: the
        survivors that do not fit enter the delta from the fp32 master
        rows, quantized by each package."""
        ji, v = _ref_index()
        pi = _carry(ji)
        jm, pm = ji.modalities["text"], pi.modalities["text"]
        p = int(np.argmax(np.asarray(jm.ivf.counts)))
        rj = jexec.merge_cold(jm, jm.stats, p)
        rp = maint_exec.merge_cold(pm, pm.stats, p)
        assert rp == rj and rp["overflow"] > 0
        _same_state(ji, pi, delta_code_tol=1)
        _same_results(ji, pi, v)

    @pytest.mark.parametrize("park_first", [False, True])
    def test_split_hot_matches_reference(self, park_first):
        """The K=2 fit seeded at the reference's rows: the reference draws
        them with ``jax.random.choice`` inside its ``fit``; the test draws
        the same rows from the same key and hands them to the port. With
        no parked partition the split first merges the coldest away."""
        ji, v = _ref_index()
        _writes(ji, n_new=0, n_upd=10, n_del=10)
        pi = _carry(ji)
        jm, pm = ji.modalities["text"], pi.modalities["text"]
        if park_first:
            cold = int(np.argmin(np.asarray(jm.ivf.counts)))
            assert jexec.merge_cold(jm, jm.stats, cold) \
                == maint_exec.merge_cold(pm, pm.stats, cold)
        hot = int(np.argmax(np.asarray(jm.ivf.counts)))
        key = jax.random.PRNGKey(7)
        rj = jexec.split_hot(jm, ji.cfg, key, jm.stats, hot)
        # the live rows the fit sees, as the reference gathers them
        n_live = rj["moved"]
        idx0 = np.asarray(jax.random.choice(key, n_live, (2,),
                                            replace=n_live < 2))
        rp = maint_exec.split_hot(pm, pi.cfg, None, pm.stats, hot,
                                  init_idx=torch.as_tensor(np.array(idx0)))
        assert rp == rj, (rp, rj)
        _same_state(ji, pi)
        _same_results(ji, pi, v)

    def test_recluster_matches_reference(self):
        ji, v = _ref_index()
        _writes(ji, n_new=0)
        pi = _carry(ji)
        for idx in (ji, pi):
            st = idx.modalities["text"].stats
            st.baseline[:] = 1e-3
            st.drift_sum[:] = 10.0
            st.drift_cnt[:] = 100
        rep = _maintain_both(ji, pi, budget=100_000)
        assert any(a.kind == "recluster" for a, _ in rep.actions)
        _same_state(ji, pi, centroids_exact=False)
        _same_results(ji, pi, v)
