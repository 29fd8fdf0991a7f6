"""The port's dynamic concurrency check (``tools/racecheck_torch.py``) on
the CPU: the canonical workload (searchers on modality "a" against one
writer on "b", under seeded interleavings) bitwise the single-threaded
oracle with zero lockset warnings and zero in-place writes to the
published state; both fixtures caught (the hot-result cache without its
lock, a writer that tombstones in place); a recorded schedule replayed
exactly; free-running threads and ``RetrievalService`` micro-batching
under client threads; and the two repairs the harness brought
(copy-on-write master rows on an update, a sharded replica without a
mesh). The card runs the same at d 384 (``test_torch_kernels_gpu.py``,
``chip_smoke.py``'s racecheck phase).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import racecheck_torch as rc  # noqa: E402


@pytest.fixture(scope="module")
def workload():
    return rc.Workload("cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_workload_is_the_oracle(workload, seed):
    r = rc.canonical_workload(seed, workload=workload)
    assert r["warnings"] == []
    assert r["mismatches"] == []
    assert r["version_changes"] == []
    assert r["ok"] and r["points"] > 100 and r["ops"] == 9


def test_recorded_schedule_replays_exactly(workload):
    first = rc.canonical_workload(5, workload=workload)
    again = rc.canonical_workload(schedule=first["schedule"],
                                  workload=workload)
    assert again["schedule"] == first["schedule"]
    assert again["ok"] and again["seed"] == 5
    seed, choices = rc.parse_schedule(first["schedule"])
    assert seed == 5 and len(choices) == first["points"]


def test_racy_cache_is_caught_and_the_ports_is_clean():
    catches, failures = rc.cache_selftest(range(8))
    assert catches >= 1 and failures == 0
    caught = [rc.run_cache_fixture(True, seed=s) for s in range(8)]
    assert any(w.startswith("lockset empty for HotResultCache")
               for r in caught for w in r["warnings"])


def test_inplace_delta_writer_is_caught(workload):
    r = rc.canonical_workload(0, workload=workload,
                              writer=rc.inplace_delete_writer)
    assert not r["ok"]
    assert r["version_changes"]
    assert all("m/b/delta/tombstones written in place" in c
               for c in r["version_changes"])


def test_version_check_sees_an_inplace_write(workload):
    index = workload.fresh()
    mark = rc.version_mark(index)
    names = [n for n, _, _ in mark]
    assert "m/a/delta/tombstones" in names and "m/b/vectors" in names
    assert rc.version_changes(mark) == []
    index.modalities["a"].delta.ids.add_(0)
    assert rc.version_changes(mark) == ["m/a/delta/ids"]


def test_free_running_threads(workload):
    r = rc.free_running(workload, n_searchers=8, rounds=2)
    assert r["ok"], r
    assert r["ops"] == 19


def test_retrieval_service_under_clients(workload):
    index = workload.fresh()
    q = np.random.default_rng(3).normal(size=(24, 16)).astype(np.float32)
    r = rc.service_clients(index, q, n_clients=16, per_client=3, k=5)
    assert r["ok"], r["mismatches"][:3]
    assert r["requests"] == 48


def test_update_publishes_new_master_rows(workload):
    """An update of existing ids builds new master rows and leaves the
    tensor a searcher may hold as it was."""
    index = workload.fresh()
    m = index.modalities["b"]
    old = m.vectors
    before = old.clone()
    ids = m.ids[:4].numpy()
    index.insert("b", ids, np.ones((4, 16), np.float32))
    assert index.modalities["b"].vectors is not old
    assert torch.equal(old, before)
    rows = index.modalities["b"].vectors[:4]
    assert torch.allclose(rows, torch.full_like(rows, 0.25))


def test_sharded_replica_without_a_mesh(workload):
    """``_ensure_sharded`` on an index with no mesh keeps the shards on
    the index's device (the reference skips the placement there)."""
    index = workload.fresh()
    sh = index._ensure_sharded("a", 2)
    assert len(sh) == 2 and sh[0].ids.device.type == "cpu"
    assert index._ensure_sharded("a", 2) is sh
    live = torch.cat([s.ids.reshape(-1) for s in sh])
    assert sorted(live[live >= 0].tolist()) == sorted(
        index.modalities["a"].ivf.ids[index.modalities["a"].ivf.ids >= 0]
        .tolist())


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_replica_without_a_mesh_matches_reference(n_shards):
    """The replica ``_ensure_sharded`` builds on an index with no mesh,
    held field by field against the reference's on the same state: shard
    s of the port is slice s of the reference's stacked layout, bitwise,
    on the index's device."""
    import dataclasses
    from repro.configs import get_config as jget_config
    from repro.core.index import HMGIIndex as JIndex
    from repro.data.synthetic import make_corpus
    from repro_torch.configs.base import HMGIConfig
    from repro_torch.convert import index_from_jax_state
    jcfg = jget_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=6,
                                       kmeans_iters=4, delta_capacity=128,
                                       maint_auto=False)
    c = make_corpus(n_nodes=600, modality_dims={"text": 32}, seed=4)
    ji = JIndex(jcfg)
    ji.ingest({"text": (c.node_ids["text"], c.vectors["text"])},
              n_nodes=c.n_nodes)
    rng = np.random.default_rng(5)
    ids = np.asarray(c.node_ids["text"])
    ji.insert("text", ids[:3], rng.normal(size=(3, 32)).astype(np.float32))
    ji.delete("text", ids[10:13])
    tree, meta = ji.state_tree()
    pi = index_from_jax_state({k: np.asarray(v) for k, v in tree.items()},
                              meta, "cpu",
                              cfg=HMGIConfig(**dataclasses.asdict(jcfg)))
    assert ji.mesh is None and pi.mesh is None
    want = ji._ensure_sharded("text", n_shards)
    got = pi._ensure_sharded("text", n_shards)
    assert len(got) == n_shards
    for s, shard in enumerate(got):
        assert shard.bits == want.bits
        for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
            w = np.asarray(getattr(want, f))[s]
            g = getattr(shard, f)
            assert g.device.type == "cpu", (s, f)
            g = g.numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (s, f)
            assert g.tobytes() == w.tobytes(), (s, f)


def test_cli_sweep_on_the_cpu(capsys):
    assert rc.main(["--sweep", "--seeds", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sweep: clean across 2 seeds" in out
    assert "in-place delta writer:" in out
