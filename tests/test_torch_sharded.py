"""The port's sharded execution path: twin of ``tests/test_sharded.py``,
plus parity with the JAX package.

The twin cases are the reference's on the CPU. The port's mesh may repeat
one device, so its multi-shard cases (the reference's ``@multi_device``
ones) run here through ``Mesh(["cpu"] * S, ("data",))``: the host loop over
shards that the reference only emulates is the port's real code path.

Within the port: sharded scores equal the single layout's with
``torch.equal`` (each row's score is summed in a fixed order, whatever its
shard), ids up to exact ties (``_assert_ids_consistent``).

Against the reference (its own kernels in Pallas interpret mode, as its
tests run them here): ``shard_index`` of a state carried over by
``convert.index_from_jax_state`` equals ``repro.core.ivf.shard_index``
leaf by leaf, byte for byte; sharded scores agree with the reference's
within rtol 1e-6 / atol 1e-6 (the two packages sum the same fp32 products
in another order), ids exactly except at ties.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as jget_config
from repro.core import ivf as jivf
from repro.core.index import HMGIIndex as JIndex
from repro.data.synthetic import make_corpus
from repro_torch.configs import get_config
from repro_torch.configs.base import HMGIConfig
from repro_torch.convert import index_from_jax_state
from repro_torch.core import HMGIIndex
from repro_torch.core import ivf as ivf_mod
from repro_torch.core.cost_model import plan_device_layout
from repro_torch.core.partitioner import assign_topk
from repro_torch.sharding import Mesh, db_shards

from test_torch_ivf_topk import assert_topk_match
from torch_query_ref import assert_matches, reference_execute

N_SHARDS = 4
RTOL = ATOL = 1e-6


def _mesh(n):
    return Mesh(["cpu"] * n, ("data",))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _vectors(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _corpus_index(rng, n=1200, d=32, k_parts=10):
    v = _vectors(rng, n, d)
    idx, _ = ivf_mod.build(_t(v), torch.arange(n), n_partitions=k_parts,
                           bits=8, generator=torch.Generator().manual_seed(0))
    q = _t(v[:12] + 0.02 * rng.normal(size=(12, d)).astype(np.float32))
    return v, idx, q


def _local(sh, s):
    return ivf_mod.IVFIndex(sh.centroids[s], sh.data[s], sh.vmin[s],
                            sh.scale[s], sh.ids[s], sh.counts[s], sh.bits)


def _assert_ids_consistent(sv, si, se, ie):
    """Scores must be identical; ids must agree except where the score ties
    make the order legally ambiguous."""
    sv, si = np.asarray(sv), np.asarray(si)
    se, ie = np.asarray(se), np.asarray(ie)
    for qi in range(sv.shape[0]):
        ref = {}
        for s, i in zip(se[qi], ie[qi]):
            if np.isfinite(s):
                ref.setdefault(float(s), set()).add(int(i))
        for s, i in zip(sv[qi], si[qi]):
            if np.isfinite(s):
                assert int(i) in ref[float(s)], (qi, int(i), float(s))


def _assert_same(got, want):
    """Port sharded vs port single: scores bit-equal, ids up to ties."""
    assert torch.equal(got[0], want[0])
    _assert_ids_consistent(got[0], got[1], want[0], want[1])


class TestShardLayout:
    def test_live_rows_and_partitions_preserved(self, rng):
        """Every live (id, partition, quantized bytes) triple survives the
        re-layout untouched — sharding moves rows, it never re-encodes."""
        _, idx, _ = _corpus_index(rng)
        s = 4
        sh = ivf_mod.shard_index(idx, s)
        k, cap = idx.ids.shape
        single = {}
        for p in range(k):
            for j in range(cap):
                i = int(idx.ids[p, j])
                if i >= 0:
                    single[i] = (p, idx.data[p, j].numpy().tobytes(),
                                 float(idx.vmin[p, j]), float(idx.scale[p, j]))
        sharded = {}
        for si in range(s):
            for p in range(k):
                for j in range(sh.ids.shape[2]):
                    i = int(sh.ids[si, p, j])
                    if i >= 0:
                        sharded[i] = (p, sh.data[si, p, j].numpy().tobytes(),
                                      float(sh.vmin[si, p, j]),
                                      float(sh.scale[si, p, j]))
        assert sharded == single
        np.testing.assert_array_equal(sh.counts.numpy().sum(axis=0),
                                      idx.counts.numpy())

    def test_round_robin_balance(self, rng):
        """Builds pack live rows into low slots, so dealing slots round-robin
        spreads each partition's rows within 1 of evenly across shards."""
        _, idx, _ = _corpus_index(rng)
        sh = ivf_mod.shard_index(idx, 4)
        per_shard = sh.counts.numpy()                         # (S, K)
        for p in range(idx.n_partitions):
            col = per_shard[:, p]
            assert col.max() - col.min() <= 1, (p, col)

    def test_centroids_replicated(self, rng):
        _, idx, _ = _corpus_index(rng)
        sh = ivf_mod.shard_index(idx, 3)
        for s in range(3):
            assert torch.equal(sh.centroids[s], idx.centroids)

    def test_rejects_bad_shard_count(self, rng):
        _, idx, _ = _corpus_index(rng, n=100, k_parts=4)
        with pytest.raises(ValueError):
            ivf_mod.shard_index(idx, 0)


class TestShardedScanEquivalence:
    """The merged sharded scan must carry the single-device scores exactly:
    same probes against the same centroids select the same candidate set,
    split S ways, in the same stored representation."""

    def _emulated(self, sh, q, *, n_probe, k, impl, node_pass=None):
        """The reference's host-side twin of its shard_map body."""
        parts = [ivf_mod.search(_local(sh, s), q, n_probe=n_probe, k=k,
                                impl=impl, node_pass=node_pass)
                 for s in range(sh.ids.shape[0])]
        allv = torch.cat([p[0] for p in parts], dim=1)
        alli = torch.cat([p[1] for p in parts], dim=1)
        mv, pos = torch.sort(allv, dim=1, descending=True, stable=True)
        mv, mi = mv[:, :k], torch.gather(alli, 1, pos[:, :k])
        return mv, torch.where(torch.isfinite(mv), mi, -1)

    @pytest.mark.parametrize("impl", ["kernel", "einsum"])
    @pytest.mark.parametrize("n_shards", [2, 3, 8])
    def test_emulated_shards_match_single(self, rng, impl, n_shards):
        _, idx, q = _corpus_index(rng)
        sh = ivf_mod.shard_index(idx, n_shards)
        for n_probe in (3, idx.n_partitions):
            want = ivf_mod.search(idx, q, n_probe=n_probe, k=10, impl=impl)
            _assert_same(self._emulated(sh, q, n_probe=n_probe, k=10,
                                        impl=impl), want)

    def test_emulated_shards_respect_node_pass(self, rng):
        v, idx, q = _corpus_index(rng)
        npass = _t(np.random.default_rng(5).random(len(v)) < 0.25)
        sh = ivf_mod.shard_index(idx, 4)
        want = ivf_mod.search(idx, q, n_probe=idx.n_partitions, k=10,
                              node_pass=npass)
        sv, si = self._emulated(sh, q, n_probe=idx.n_partitions, k=10,
                                impl="auto", node_pass=npass)
        _assert_same((sv, si), want)
        live = si.numpy()[np.isfinite(sv.numpy())]
        assert np.all(npass.numpy()[live])

    @pytest.mark.parametrize("impl", ["kernel", "einsum"])
    @pytest.mark.parametrize("n_shards", [2, 3, 8])
    def test_mesh_path_matches_single(self, rng, impl, n_shards):
        """``search_sharded`` itself over a mesh of S CPU shards."""
        _, idx, q = _corpus_index(rng)
        mesh = _mesh(n_shards)
        sh = ivf_mod.shard_index(idx, n_shards)
        for n_probe in (3, idx.n_partitions):
            want = ivf_mod.search(idx, q, n_probe=n_probe, k=10, impl=impl)
            _assert_same(ivf_mod.search_sharded(sh, q, mesh, n_probe=n_probe,
                                                k=10, impl=impl), want)

    def test_mesh_path_masks_and_probes(self, rng):
        v, idx, q = _corpus_index(rng)
        mesh = _mesh(N_SHARDS)
        sh = ivf_mod.shard_index(idx, N_SHARDS)
        npass = _t(np.random.default_rng(7).random(len(v)) < 0.3)
        probes, _ = assign_topk(q, idx.centroids, 5)
        want = ivf_mod.search(idx, q, n_probe=5, k=10, probes=probes,
                              node_pass=npass)
        _assert_same(ivf_mod.search_sharded(sh, q, mesh, n_probe=5, k=10,
                                            probes=probes, node_pass=npass),
                     want)

    def test_padding_semantics_tiny_corpus(self, rng):
        """k far beyond the live rows: the sharded merge must pad (-inf, -1)
        exactly like the single scan — no shard's pad slot may leak."""
        _, idx, q = _corpus_index(rng, n=40, d=16, k_parts=4)
        sh = ivf_mod.shard_index(idx, 4)
        want = ivf_mod.search(idx, q[:4], n_probe=4, k=64)
        for sv, si in (self._emulated(sh, q[:4], n_probe=4, k=64,
                                      impl="auto"),
                       ivf_mod.search_sharded(sh, q[:4], _mesh(4), n_probe=4,
                                              k=64)):
            assert torch.equal(sv, want[0])
            dead = ~torch.isfinite(sv)
            assert bool((si[dead] == -1).all())

    def test_placement_views_one_device(self, rng):
        """On a mesh that repeats one device the placed shards are views of
        the stacked layout (no second copy of the slab)."""
        _, idx, _ = _corpus_index(rng)
        sh = ivf_mod.shard_index(idx, 3)
        placed = ivf_mod.shard_placement(_mesh(3))(sh)
        assert len(placed) == 3
        for s, loc in enumerate(placed):
            assert loc.data.data_ptr() == sh.data[s].data_ptr()
            assert torch.equal(loc.ids, sh.ids[s])
        with pytest.raises(ValueError):
            ivf_mod.shard_placement(_mesh(2))(sh)


# ---------------------------------------------------------------------------
# facade: the planner routes search/hybrid_search/query through the sharded
# path transparently, and results stay bit-identical to the single layout
# ---------------------------------------------------------------------------

def _build_facade(corpus, layout, mesh=None):
    cfg = get_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=6,
                                     kmeans_iters=4, delta_capacity=128,
                                     shard_layout=layout)
    idx = HMGIIndex(cfg, mesh=mesh, seed=0, device="cpu")
    idx.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
                for m in corpus.vectors}, n_nodes=corpus.n_nodes,
               edges=(corpus.src, corpus.dst, corpus.edge_type),
               node_attrs={"year": np.arange(corpus.n_nodes) % 7})
    rng = np.random.default_rng(3)
    ids = np.asarray(corpus.node_ids["text"])
    nv = rng.normal(size=(3, 32)).astype(np.float32)
    idx.insert("text", ids[:3], nv)                    # MVCC updates
    idx.delete("text", ids[10:13])                     # tombstones
    return idx


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_nodes=700, modality_dims={"text": 32, "image": 48},
                       seed=1)


class TestShardedFacade:
    @pytest.fixture(scope="class")
    def pair(self, corpus):
        return (_build_facade(corpus, "single"),
                _build_facade(corpus, "sharded", _mesh(N_SHARDS)))

    def test_planner_reports_sharded_layout(self, pair, corpus):
        from repro_torch.query import Q
        _, b = pair
        desc = b.explain(Q.vector("text", corpus.vectors["text"][:2]).topk(3))
        assert f"layout=sharded(x{N_SHARDS})" in desc

    def test_search_matches_single_layout(self, pair, corpus):
        a, b = pair
        q = corpus.vectors["text"][:10]
        for kw in (dict(), dict(where=("year", "<", 3)), dict(n_probe=2),
                   dict(impl="einsum")):
            _assert_same(b.search(q, "text", k=6, **kw),
                         a.search(q, "text", k=6, **kw))

    def test_hybrid_matches_single_layout(self, pair, corpus):
        a, b = pair
        q = corpus.vectors["text"][:8]
        _assert_same(b.hybrid_search(q, "text", k=6, n_hops=2),
                     a.hybrid_search(q, "text", k=6, n_hops=2))

    def test_query_plan_matches_oracle(self, pair, corpus):
        """Full-probe declarative chains through the sharded path must equal
        the brute-force numpy oracle (stable + delta, tombstones, Where)."""
        from repro_torch.query import Q
        from repro_torch.query.planner import compile_plan
        _, b = pair
        q = corpus.vectors["text"][:6]
        for plan in (Q.vector("text", q, n_probe=8).topk(6),
                     Q.vector("text", q, n_probe=8)
                      .where(("year", "<", 5)).topk(6),
                     Q.vector("text", q, n_probe=8).traverse(1).topk(6)):
            phys = compile_plan(b, plan)
            assert phys.source.layout.layout == "sharded"
            assert_matches(b.query(plan), reference_execute(b, phys))

    def test_mutation_invalidates_sharded_replica(self, corpus):
        b = _build_facade(corpus, "sharded", _mesh(N_SHARDS))
        q = corpus.vectors["text"][:4]
        b.search(q, "text", k=4)                        # builds the replica
        assert b.modalities["text"].ivf_sharded is not None
        b.compact("text")
        assert b.modalities["text"].ivf_sharded is None
        a = _build_facade(corpus, "single")
        a.compact("text")
        _assert_same(b.search(q, "text", k=4), a.search(q, "text", k=4))

    def test_rag_engine_retrieves_through_sharded_path(self, pair, corpus):
        """RAGEngine.retrieve -> hybrid_search -> sharded seed scan."""
        from repro_torch.configs import smoke_config
        from repro_torch.models import lm
        from repro_torch.serving.engine import EngineConfig, RAGEngine
        a, b = pair
        lcfg = smoke_config("phi4-mini-3.8b").replace(dtype="float32")
        eng_b = RAGEngine(lcfg, lm.init_lm(lcfg, 0, device="cpu"), b,
                          EngineConfig(retrieve_k=4, hops=1, n_slots=1,
                                       max_seq=16, maintenance_interval=0,
                                       retrieval_cache_capacity=0),
                          device="cpu")
        q = corpus.vectors["text"][:3]
        np.testing.assert_array_equal(
            eng_b.retrieve(q),
            a.hybrid_search(q, "text", k=4, n_hops=1)[1].numpy())

    def test_cold_replica_built_once_under_threads(self, corpus, monkeypatch):
        """Eight searchers racing on a cold replica: one build, published
        once; every thread sees the single layout's results."""
        a = _build_facade(corpus, "single")
        b = _build_facade(corpus, "sharded", _mesh(N_SHARDS))
        calls = []
        real = ivf_mod.shard_index

        def counted(index, n):
            calls.append(n)
            return real(index, n)
        monkeypatch.setattr(ivf_mod, "shard_index", counted)
        q = corpus.vectors["text"][:5]
        want = a.search(q, "text", k=6)
        go = threading.Barrier(8)
        out, errors = [None] * 8, []

        def worker(i):
            try:
                go.wait(timeout=60)
                out[i] = b.search(q, "text", k=6)
            except Exception as e:          # surfaced below
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert calls == [N_SHARDS]
        for got in out:
            _assert_same(got, want)


class TestDeviceLayoutPlanning:
    def test_crossover(self):
        small = plan_device_layout(10_000, 64, n_shards=8,
                                   budget_bytes=1 << 30)
        big = plan_device_layout(50_000_000, 128, n_shards=8,
                                 budget_bytes=1 << 30)
        assert small.layout == "single" and small.n_shards == 1
        assert big.layout == "sharded" and big.n_shards == 8

    def test_force_overrides(self):
        assert plan_device_layout(10, 8, n_shards=4, budget_bytes=1 << 30,
                                  force="sharded").layout == "sharded"
        assert plan_device_layout(10 ** 9, 128, n_shards=4, budget_bytes=1,
                                  force="single").layout == "single"
        with pytest.raises(ValueError):
            plan_device_layout(10, 8, n_shards=4, budget_bytes=0, force="bogus")

    def test_one_shard_degenerates_to_single(self):
        assert plan_device_layout(10 ** 9, 128, n_shards=1, budget_bytes=1,
                                  force="sharded").layout == "single"

    def test_facade_single_without_mesh(self, corpus):
        idx = _build_facade(corpus, "sharded", mesh=None)   # no mesh => single
        assert idx.device_layout("text").layout == "single"
        idx.search(corpus.vectors["text"][:2], "text", k=3)
        assert idx.modalities["text"].ivf_sharded is None

    @pytest.mark.parametrize("shape,names", [((4,), ("data",)),
                                             ((2, 4), ("pod", "data")),
                                             ((2, 4), ("data", "model")),
                                             ((8,), ("model",))])
    def test_rules_match_reference(self, shape, names):
        """``logical_to_spec`` (both fallbacks), ``batch_axes``,
        ``db_axes``, ``db_shards`` and ``rule_overrides`` against the
        reference's, on meshes of the same shape (the reference's over
        CPU device placeholders: its rules read only the mesh's shape)."""
        from repro.sharding import rules as jrules
        from repro_torch.sharding import (batch_axes, db_axes,
                                          logical_to_spec, rule_overrides)

        class _JShape:                     # a reference mesh's shape only
            def __init__(self, shape, names):
                self.shape = dict(zip(names, shape))
        jm = _JShape(shape, names)
        pm = Mesh(np.full(shape, "cpu", dtype=object), names)
        assert pm.shape == jm.shape
        cases = [(["batch", "embed"], [6, 32]), (["batch", "seq"], [8, 5]),
                 (["kv_heads", "head_dim"], [8, 64]), (["mlp"], [12]),
                 (["db", "partitions", "dim"], [4, 3, 5]),
                 (["embed_fsdp", "mlp"], [16, 16]), ([None, "vocab"], [3, 8])]
        for axes, dims in cases:
            for d in (dims, None):
                assert logical_to_spec(axes, pm, dims=d) == tuple(
                    jrules.logical_to_spec(axes, jm, dims=d)), (axes, d)
        with rule_overrides({"mlp": None}), jrules.rule_overrides(
                {"mlp": None}):
            assert logical_to_spec(["mlp"], pm, dims=[12]) == tuple(
                jrules.logical_to_spec(["mlp"], jm, dims=[12]))
        for n in (1, 2, 6, 8, 256):
            assert batch_axes(pm, n) == jrules.batch_axes(jm, n)
        assert db_axes(pm) == jrules.db_axes(jm)
        assert db_shards(pm) == jrules.db_shards(jm)

    def test_db_shards(self):
        assert db_shards(None) == 1
        assert db_shards(_mesh(N_SHARDS)) == N_SHARDS
        two_d = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4),
                     ("pod", "model"))
        assert db_shards(two_d) == 2
        assert ivf_mod.shard_devices(two_d) == (torch.device("cpu"),) * 2

    def test_auto_layout_follows_the_budget(self, corpus):
        """Under ``shard_layout="auto"`` the facade shards exactly where the
        reference's ``plan_device_layout`` does: the slab against the
        per-device budget."""
        cfg = get_config("hmgi").replace(n_partitions=8, kmeans_iters=2)
        idx = HMGIIndex(cfg, mesh=_mesh(2), device="cpu")
        idx.ingest({"text": (corpus.node_ids["text"],
                             corpus.vectors["text"])}, corpus.n_nodes)
        m = idx.modalities["text"]
        slab = int(m.ivf.data.numel())
        assert idx.device_layout("text").layout == "single"
        idx.cfg = cfg.replace(shard_device_budget_bytes=slab - 1)
        assert idx.device_layout("text") == plan_device_layout(
            m.ivf.data.shape[0] * m.ivf.data.shape[1], m.ivf.data.shape[2],
            n_shards=2, budget_bytes=slab - 1)
        assert idx.device_layout("text").n_shards == 2


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _assert_close(got, want):
    """Port vs reference: scores within RTOL/ATOL, finiteness and padding
    equal, ids equal except inside runs of scores tied within that
    tolerance (``assert_topk_match``)."""
    ws = np.asarray(want[0])
    fin = np.isfinite(ws)
    np.testing.assert_allclose(np.where(fin, np.asarray(got[0]), 0.0),
                               np.where(fin, ws, 0.0), rtol=RTOL, atol=ATOL)
    assert_topk_match(want, got, atol=ATOL + RTOL * float(
        np.abs(ws[fin]).max(initial=0.0)))


def _jcfg(**kw):
    j = jget_config("hmgi").replace(n_partitions=8, n_probe=8, top_k=6,
                                    kmeans_iters=4, delta_capacity=128,
                                    maint_auto=False, **kw)
    return j, HMGIConfig(**dataclasses.asdict(j))


@pytest.fixture(scope="module")
def jpair(corpus):
    """A reference facade (single layout) after MVCC writes, and its state
    carried into a port facade on a 4-shard CPU mesh."""
    jcfg, _ = _jcfg()
    _, pcfg = _jcfg(shard_layout="sharded")
    ji = JIndex(jcfg)
    ji.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
               for m in corpus.vectors}, n_nodes=corpus.n_nodes,
              edges=(corpus.src, corpus.dst, corpus.edge_type),
              node_attrs={"year": np.arange(corpus.n_nodes) % 7})
    rng = np.random.default_rng(3)
    ids = np.asarray(corpus.node_ids["text"])
    ji.insert("text", ids[:3], rng.normal(size=(3, 32)).astype(np.float32))
    ji.delete("text", ids[10:13])
    tree, meta = ji.state_tree()
    tree = {k: np.asarray(v) for k, v in tree.items()}
    return ji, index_from_jax_state(tree, meta, "cpu", cfg=pcfg,
                                    mesh=_mesh(N_SHARDS))


class TestReferenceParity:
    @pytest.mark.parametrize("n_shards", [2, 3, 8])
    def test_shard_index_matches_reference_bytes(self, jpair, n_shards):
        ji, pi = jpair
        want = jivf.shard_index(ji.modalities["text"].ivf, n_shards)
        got = ivf_mod.shard_index(pi.modalities["text"].ivf, n_shards)
        assert got.bits == want.bits
        for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
            w = np.asarray(getattr(want, f))
            g = getattr(got, f).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert g.tobytes() == w.tobytes(), f

    def test_search_sharded_matches_reference_shard_loop(self, rng):
        """Port ``search_sharded`` at S=4 against the reference's emulated
        shard loop at S=4 over the same slab."""
        v = _vectors(rng, 1200, 32)
        jidx, _ = jivf.build(jax.random.PRNGKey(0), jnp.asarray(v),
                             jnp.arange(1200), n_partitions=10, bits=8)
        pidx = ivf_mod.IVFIndex(
            *(_t(np.asarray(getattr(jidx, f))) for f in
              ("centroids", "data", "vmin", "scale", "ids", "counts")),
            bits=jidx.bits)
        q = v[:12] + 0.02 * rng.normal(size=(12, 32)).astype(np.float32)
        jsh = jivf.shard_index(jidx, N_SHARDS)
        psh = ivf_mod.shard_index(pidx, N_SHARDS)
        for n_probe in (3, 10):
            parts = [jivf.search(
                jivf.IVFIndex(jsh.centroids[s], jsh.data[s], jsh.vmin[s],
                              jsh.scale[s], jsh.ids[s], jsh.counts[s],
                              jsh.bits), jnp.asarray(q), n_probe=n_probe,
                k=10) for s in range(N_SHARDS)]
            allv = jnp.concatenate([p[0] for p in parts], axis=1)
            alli = jnp.concatenate([p[1] for p in parts], axis=1)
            mv, pos = jax.lax.top_k(allv, 10)
            mi = jnp.where(jnp.isfinite(mv),
                           jnp.take_along_axis(alli, pos, axis=1), -1)
            _assert_close(ivf_mod.search_sharded(psh, _t(q), _mesh(N_SHARDS),
                                                 n_probe=n_probe, k=10),
                          (mv, mi))

    def test_one_shard_matches_reference_mesh(self, rng):
        """Port S=1 against the reference's ``search_sharded`` on its
        1-device mesh."""
        v = _vectors(rng, 512, 32)
        jidx, _ = jivf.build(jax.random.PRNGKey(2), jnp.asarray(v),
                             jnp.arange(512), n_partitions=8, bits=8)
        jleaves = jax.tree_util.tree_map(lambda a: a[None], jidx)
        pleaves = ivf_mod.IVFIndex(
            *(_t(np.asarray(getattr(jleaves, f))) for f in
              ("centroids", "data", "vmin", "scale", "ids", "counts")),
            bits=jidx.bits)
        q = v[:8]
        want = jivf.search_sharded(
            jleaves, jnp.asarray(q),
            JMesh(np.array(jax.devices()[:1]), ("data",)), n_probe=8, k=5)
        _assert_close(ivf_mod.search_sharded(pleaves, _t(q), _mesh(1),
                                             n_probe=8, k=5), want)

    def test_mesh_facade_matches_reference_facade(self, jpair, corpus):
        """A port facade on a 4-shard mesh against the reference's
        single-layout facade over the same state: search, filtered search,
        hybrid search and ``explain``'s seed stage."""
        from repro.query import Q as JQ
        from repro_torch.query import Q as PQ
        ji, pi = jpair
        q = corpus.vectors["text"][:10]
        for kw in (dict(), dict(where=("year", "<", 3)), dict(n_probe=2)):
            _assert_close(pi.search(q, "text", k=6, **kw),
                          ji.search(q, "text", k=6, **kw))
        _assert_close(pi.hybrid_search(q, "text", k=6, n_hops=2),
                      ji.hybrid_search(q, "text", k=6, n_hops=2))
        assert pi.explain(PQ.vector("text", q).topk(6)) == ji.explain(
            JQ.vector("text", q).topk(6)).replace(
                "]", f" layout=sharded(x{N_SHARDS})]", 1)
