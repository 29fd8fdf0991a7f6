"""Twin of ``tests/test_obs.py`` on the port (``repro_torch.obs``, indexes
on the CPU). Left out: ``test_staticcheck_all_stays_clean`` (the JAX
package's own lint gate).

Observability layer: registry math, span semantics, exporters, wiring.

Covers the obs package contract: histogram bucket/quantile math against a
numpy oracle, nested span parenting and exception safety, registry reset
isolation, the zero-sync guarantee when ``obs_sync_spans`` is off, the
Prometheus exposition round-trip, and the integration points (facade
``trace=``, ``metrics()["obs"]``, the progressive rounds and the rerank
lane's span).
"""
import json

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics


@pytest.fixture(autouse=True)
def _clean_registry():
    """Every test starts from an empty global registry with sync off."""
    obs.reset()
    obs.set_enabled(True)
    obs.set_sync_spans(False)
    yield
    obs.reset()
    obs.set_enabled(True)
    obs.set_sync_spans(False)


# ---------------------------------------------------------------- histograms
def test_histogram_buckets_match_manual_count(rng):
    h = obs.histogram("t.lat")
    xs = rng.gamma(2.0, 5.0, size=500)          # ms-ish latencies
    for x in xs:
        h.observe(x)
    cum = h.cumulative_buckets()
    for le, got in cum:
        assert got == int(np.sum(xs <= le)), f"bucket le={le}"
    assert cum[-1][1] == len(xs)                 # +inf holds everything
    assert h.count == len(xs)
    assert h.total == pytest.approx(float(np.sum(xs)))
    assert h.vmax == pytest.approx(float(np.max(xs)))


def test_histogram_quantiles_match_numpy_oracle(rng):
    h = obs.histogram("t.q")
    xs = rng.normal(50.0, 10.0, size=1000)
    for x in xs:
        h.observe(x)
    for p in (50, 90, 99, 0, 100, 37.5):
        assert h.percentile(p) == pytest.approx(float(np.percentile(xs, p)))


def test_histogram_window_keeps_newest(rng):
    """Past the ring window, quantiles are over the newest `window`
    observations — old samples age out."""
    h = obs.histogram("t.w")
    n = obs_metrics.DEFAULT_WINDOW
    for _ in range(n):
        h.observe(1.0)
    for _ in range(n):
        h.observe(100.0)
    assert h.percentile(50) == pytest.approx(100.0)   # old 1.0s aged out
    assert h.count == 2 * n                           # totals never age
    assert h.cumulative_buckets()[-1][1] == 2 * n


def test_histogram_empty_and_bad_buckets():
    h = obs.histogram("t.e")
    assert np.isnan(h.percentile(50))
    assert np.isnan(h.summary()["p99"])
    with pytest.raises(ValueError):
        obs_metrics.Histogram("bad", buckets=(5.0, 1.0, float("inf")))
    with pytest.raises(ValueError):
        obs_metrics.Histogram("bad", buckets=(1.0, 5.0))   # no +inf


def test_counter_gauge_and_disable():
    obs.counter("t.c").inc()
    obs.counter("t.c").inc(3)
    obs.gauge("t.g").set(7)
    assert obs.registry().counter("t.c").value == 4
    assert obs.registry().gauge("t.g").value == 7
    obs.set_enabled(False)
    obs.counter("t.c").inc(100)
    obs.gauge("t.g").set(0)
    obs.histogram("t.h").observe(1.0)
    obs.set_enabled(True)
    snap = obs.snapshot()
    assert snap["counters"]["t.c"] == 4          # disabled writes dropped
    assert snap["gauges"]["t.g"] == 7
    assert snap["histograms"]["t.h"]["count"] == 0


def test_registry_reset_between_tests_part1():
    obs.counter("leak.check").inc()


def test_registry_reset_between_tests_part2():
    # runs after part1; the autouse fixture must have wiped its counter
    assert "leak.check" not in obs.snapshot()["counters"]


# --------------------------------------------------------------------- spans
def test_span_records_duration_histogram():
    with obs.span("t.span"):
        pass
    h = obs.registry().histogram("t.span")
    assert h.count == 1
    assert h.vmax >= 0.0


def test_nested_span_parenting():
    with obs.trace() as t:
        with obs.span("outer"):
            with obs.span("inner.a"):
                pass
            with obs.span("inner.b"):
                with obs.span("leaf"):
                    pass
    root = t.root
    assert root.name == "outer"
    assert [c.name for c in root.children] == ["inner.a", "inner.b"]
    assert [c.name for c in root.children[1].children] == ["leaf"]
    assert t.find("leaf") is not None
    # every node carries a recorded duration
    assert all(np.isfinite(n.duration_ms)
               for n in [root, *root.children, root.children[1].children[0]])
    # the render is one line per span, indented by depth
    lines = t.render().splitlines()
    assert len(lines) == 4 and lines[0].startswith("outer")
    assert lines[1].startswith("  inner.a")


def test_span_closed_and_recorded_on_raise():
    with pytest.raises(RuntimeError):
        with obs.trace() as t:
            with obs.span("boom"):
                raise RuntimeError("x")
    h = obs.registry().histogram("boom")
    assert h.count == 1                          # duration still recorded
    node = t.find("boom")
    assert node.error == "RuntimeError"
    # the per-thread stack unwound: a fresh span is a root again
    with obs.trace() as t2:
        with obs.span("after"):
            pass
    assert t2.root.name == "after"


def test_spans_without_trace_still_feed_registry():
    with obs.span("untraced"):
        pass
    assert obs.registry().histogram("untraced").count == 1


def test_fence_noop_when_sync_off(monkeypatch):
    """obs_sync_spans off: span exit must never synchronise the device —
    the zero-overhead contract for always-on instrumentation."""
    from repro_torch.obs import spans as obs_spans
    calls = []
    monkeypatch.setattr(obs_spans, "_synchronize",
                        lambda x: calls.append(1))
    with obs.span("t.f") as sp:
        assert sp.fence("value") == "value"      # passthrough either way
    assert calls == []
    obs.set_sync_spans(True)
    with obs.span("t.f") as sp:
        sp.fence("value")
    assert calls == [1]


# ----------------------------------------------------------------- exporters
def test_prometheus_roundtrip(rng):
    obs.counter("q.count").inc(5)
    obs.gauge("q.depth").set(3)
    h = obs.histogram("q.lat")
    xs = rng.gamma(2.0, 5.0, size=200)
    for x in xs:
        h.observe(x)
    text = obs.render_prometheus()
    back = obs.parse_prometheus(text)
    assert back["counters"]["hmgi_q_count"] == 5
    assert back["gauges"]["hmgi_q_depth"] == 3
    hb = back["histograms"]["hmgi_q_lat"]
    assert hb["count"] == 200
    assert hb["sum"] == pytest.approx(float(np.sum(xs)), rel=1e-6)
    assert hb["buckets"] == h.cumulative_buckets()
    # exposition shape: cumulative, ends at +Inf == count
    les = [le for le, _ in hb["buckets"]]
    assert les == sorted(les) and les[-1] == float("inf")
    assert hb["buckets"][-1][1] == hb["count"]


def test_snapshot_is_json_serialisable():
    obs.counter("j.c").inc()
    obs.histogram("j.h").observe(1.5)
    out = json.loads(json.dumps(obs.snapshot()))
    assert out["histograms"]["j.h"]["count"] == 1


# ------------------------------------------------------------- facade wiring
@pytest.fixture(scope="module")
def small_index():
    from repro_torch.configs import get_config
    from repro_torch.core import HMGIIndex
    rng = np.random.default_rng(7)
    cfg = get_config("hmgi").replace(
        modalities=("text",), n_partitions=4, n_probe=4, kmeans_iters=4,
        top_k=5, delta_capacity=64)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    vecs = rng.normal(size=(128, cfg.dim)).astype(np.float32)
    edges = (np.arange(128), (np.arange(128) + 1) % 128)
    idx.ingest({"text": (np.arange(128), vecs)}, n_nodes=128, edges=edges)
    return idx, vecs


def test_search_trace_option(small_index):
    idx, vecs = small_index
    q = vecs[:2]
    sv, si = idx.search(q, "text", k=5)           # default: 2-tuple compat
    sv2, si2, t = idx.search(q, "text", k=5, trace=True)
    np.testing.assert_array_equal(np.asarray(si), np.asarray(si2))
    names = {n.name for n in t.roots}
    assert names == {"query.plan", "query.execute"}
    assert t.find("query.seed_scan") is not None
    assert "query.execute" in t.render()


def test_hybrid_search_trace_spans(small_index):
    idx, vecs = small_index
    _, _, t = idx.hybrid_search(vecs[:2], "text", k=5, n_hops=1, trace=True)
    for name in ("query.plan", "query.execute", "query.seed_scan",
                 "query.traversal", "query.fusion"):
        assert t.find(name) is not None, name


def test_metrics_obs_section_and_registry_population(small_index):
    idx, vecs = small_index
    idx.search(vecs[:2], "text", k=5)
    m = idx.metrics()
    hs = m["obs"]["histograms"]
    assert hs["query.execute"]["count"] >= 1
    assert np.isfinite(hs["query.execute"]["p50"])
    assert "query.seed_scan" in hs


def test_progressive_rounds_counter(small_index):
    from repro_torch.core.progressive import progressive_search
    idx, vecs = small_index
    m = idx.modalities["text"]
    results = list(progressive_search(m.ivf, vecs[:2], k=5,
                                      probe_schedule=(1, 2, 4)))
    assert len(results) == 3
    assert obs.registry().counter("progressive.rounds").value == 3
    assert obs.registry().histogram("progressive.round").count == 3
    # elapsed is accumulated *work* time: monotone across rounds
    els = [r.elapsed_s for r in results]
    assert els == sorted(els) and els[0] > 0


def test_rerank_lane_rescore_span(small_index):
    """The rerank lane runs inside its own ``query.rescore`` span, nested
    in the traced hybrid query's tree."""
    from repro_torch.core.rerank import SparseVectors, hash_terms
    import torch
    idx, vecs = small_index
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, 1000, (128, 8)))
    idx.set_sparse_docs(SparseVectors(hash_terms(tok, 256),
                                      torch.rand(128, 8)))
    _, _, t = idx.hybrid_search(vecs[:2], "text", k=5, n_hops=1,
                                use_rerank=True,
                                q_terms=hash_terms(tok[0], 256),
                                q_term_weights=torch.ones(8), trace=True)
    assert t.find("query.rescore") is not None
    assert [r.name for r in t.roots] == ["query.plan", "query.execute",
                                         "query.rescore"]
    assert obs.registry().histogram("query.rescore").count == 1


def test_write_spans_record(small_index):
    """insert and delete each record their span (maintenance inside)."""
    from repro_torch.configs import get_config
    from repro_torch.core import HMGIIndex
    _, vecs = small_index
    cfg = get_config("hmgi").replace(
        modalities=("text",), n_partitions=4, n_probe=4, kmeans_iters=4,
        top_k=5, delta_capacity=64)
    idx = HMGIIndex(cfg, seed=0, device="cpu")
    idx.ingest({"text": (np.arange(128), vecs)}, n_nodes=200)
    with obs.trace() as t:
        idx.insert("text", np.array([150, 3]), vecs[:2])
        idx.delete("text", np.array([150]))
    assert [r.name for r in t.roots] == ["index.insert", "index.delete"]
    reg = obs.registry()
    assert reg.histogram("index.insert").count == 1
    assert reg.histogram("index.delete").count == 1
    assert t.find("index.delete").find("index.maintain") is not None


def test_wal_histograms_populate(tmp_path):
    from repro_torch.persistence.oplog import OpLog
    log = OpLog(str(tmp_path), sync_every=2)
    for i in range(4):
        log.append("op", {"i": i}, {"a": np.arange(3, dtype=np.int32)})
    log.close()
    reg = obs.registry()
    assert reg.histogram("wal.append").count == 4
    assert reg.histogram("wal.fsync").count == 2      # group commit of 2
    assert reg.histogram("wal.sync_batch").percentile(50) == 2.0
