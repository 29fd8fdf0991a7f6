"""The port's serving layer against the JAX package's: torch twins of
``tests/test_serving.py`` (continuous batching over ragged prompts equals
sequential per-request decoding token for token, zero-token requests,
dropped ``-1`` retrieval ids, the scheduler's lifecycle), the RAG engine
over an index carried over from the reference, ``search_bucketed``, the
micro-batcher, the hot-result cache and the obs registry.

The LM runs the reference's ``smoke_config("phi4-mini-3.8b")`` widths in
fp32 with the reference's parameters (``convert.lm_params_from_jax``), so
token streams are compared for equality with the JAX engine's. Retrieval
scores agree to 1e-5 absolute (fp32 sums in another order) and ids match
up to score ties (``assert_topk_match``).
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import threading

import numpy as np
import jax
import torch

from repro import obs as jobs
from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.core.index import HMGIIndex as JIndex
from repro.data.synthetic import make_corpus
from repro.models import lm as jlm
from repro.query.executor import search_bucketed as j_search_bucketed
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import RAGEngine as JRAGEngine
from repro_torch import obs
from repro_torch.configs.base import HMGIConfig, LMConfig
from repro_torch.convert import index_from_jax_state, lm_params_from_jax
from repro_torch.models import lm
from repro_torch.query.executor import search_bucketed
from repro_torch.serving.cache import HotResultCache, query_signature
from repro_torch.serving.engine import EngineConfig, RAGEngine
from repro_torch.serving.retrieval import (MicroBatcher, RetrievalPlan,
                                           RetrievalService, run_plan)
from repro_torch.serving.scheduler import (AdmissionController,
                                           ContinuousBatcher, Request,
                                           TenantQuota)
from repro_torch.sharding import Mesh
from test_torch_ivf_topk import assert_topk_match

MAX_SEQ = 48
N = 400


def _lm_pair(arch="phi4-mini-3.8b", **kw):
    # fp32: batched-vs-single decode must agree to the argmax
    jcfg = jsmoke(arch).replace(dtype="float32", **kw)
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, LMConfig(**dataclasses.asdict(jcfg)), pp


@pytest.fixture(scope="module")
def lm_setup():
    return _lm_pair()


def _engine(cfg, params, index=None, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return RAGEngine(cfg, params, index, EngineConfig(**kw), device="cpu")


def _sequential(cfg, params, prompt, n):
    """Reference: one request at a time, prefill then single-row decode."""
    clen = lm.cache_len_for(cfg, MAX_SEQ)
    logits, cache = lm.prefill(cfg, params, torch.as_tensor(prompt)[None],
                               margin=clen - len(prompt))
    gen = [int(torch.argmax(logits[0]))]
    pos = len(prompt)
    while len(gen) < n:
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.tensor([gen[-1]]), torch.tensor([pos]))
        gen.append(int(torch.argmax(lg[0])))
        pos += 1
    return gen


# ------------------------------------------------------------ per-slot decode
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen2-72b",
                                  "deepseek-v2-lite-16b"])
def test_ragged_batch_matches_single_rows(arch):
    """lm.decode_step with a (B,) position vector: each row behaves as if
    decoded alone at its own position. Capacity factor 16, as in the
    reference's test: at the default capacity a MoE row's output depends
    on its batch (capacity drops), by the reference's semantics."""
    _, _, cfg, params = _lm_pair(arch, capacity_factor=16.0)
    rng = np.random.default_rng(1)
    la, lb = 5, 9
    pa = torch.as_tensor(rng.integers(0, cfg.vocab_size, la))
    pb = torch.as_tensor(rng.integers(0, cfg.vocab_size, lb))
    clen = lm.cache_len_for(cfg, 24)
    _, ca = lm.prefill(cfg, params, pa[None], margin=clen - la)
    _, cb = lm.prefill(cfg, params, pb[None], margin=clen - lb)
    batched = tuple(torch.cat([a, b], dim=1) for a, b in zip(ca, cb))
    ra, _ = lm.decode_step(cfg, params, ca, torch.tensor([7]),
                           torch.tensor([la]))
    rb, _ = lm.decode_step(cfg, params, cb, torch.tensor([11]),
                           torch.tensor([lb]))
    rab, _ = lm.decode_step(cfg, params, batched, torch.tensor([7, 11]),
                            torch.tensor([la, lb]))
    torch.testing.assert_close(rab[0], ra[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rab[1], rb[0], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- continuous batching
def test_ragged_prompts_match_sequential(lm_setup):
    """More requests than slots, all prompt lengths different: the engine's
    streams equal sequential decoding exactly."""
    _, _, cfg, params = lm_setup
    rng = np.random.default_rng(0)
    lens = (3, 11, 7, 5, 9)
    news = (6, 4, 8, 1, 5)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    ref = {i: _sequential(cfg, params, p, n)
           for i, (p, n) in enumerate(zip(prompts, news))}
    eng = _engine(cfg, params, n_slots=2)
    for i, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(i, p, max_new_tokens=n)
    got = eng.run_to_completion()
    assert got == ref
    assert eng.stats["ticks"] > 0
    assert obs.registry().histogram("serving.decode_step").count > 0


def test_zero_token_request_returns_empty(lm_setup):
    _, _, cfg, params = lm_setup
    rng = np.random.default_rng(2)
    p0 = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    p1 = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    eng = _engine(cfg, params, n_slots=2)
    eng.submit(0, p0, max_new_tokens=0)
    eng.submit(1, p1, max_new_tokens=3)
    got = eng.run_to_completion()
    assert got[0] == []
    assert got[1] == _sequential(cfg, params, p1, 3)


def test_padded_retrieved_ids_dropped(lm_setup):
    _, _, cfg, params = lm_setup
    eng = _engine(cfg, params, n_slots=2)
    prompt = np.arange(5, dtype=np.int32)
    eng.submit(0, prompt, retrieved_ids=np.array([8, -1, 3, -1, -1]),
               max_new_tokens=1)
    built = eng.batcher.requests[0].prompt
    assert len(built) == len(prompt) + 2           # only the 2 real ids
    assert np.array_equal(built[:2], np.array([8, 3]) % (cfg.vocab_size // 4))


def test_retrieval_context_changes_prompt(lm_setup):
    _, _, cfg, params = lm_setup
    eng = _engine(cfg, params, n_slots=1)
    prompt = np.arange(4, dtype=np.int32)
    eng.submit(0, prompt, retrieved_ids=np.array([17, 42]), max_new_tokens=2)
    built = eng.batcher.requests[0].prompt
    assert eng.run_to_completion()[0] == _sequential(cfg, params, built, 2)


def test_engine_streams_equal_reference_engine(lm_setup):
    """The port's RAGEngine and the JAX RAGEngine, same weights, same
    requests (3 slots, 7 ragged requests): identical token streams."""
    jcfg, jp, cfg, params = lm_setup
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32), int(n))
            for L, n in zip(rng.integers(2, 14, 7), rng.integers(1, 9, 7))]
    j = JRAGEngine(jcfg, jp, None, JEngineConfig(n_slots=3, max_seq=MAX_SEQ))
    p = _engine(cfg, params, n_slots=3)
    for eng in (j, p):
        for i, (pr, n) in enumerate(reqs):
            eng.submit(i, pr, max_new_tokens=n)
    assert p.run_to_completion() == j.run_to_completion()
    assert p.stats["ticks"] == j.stats["ticks"]
    assert p.stats["tokens"] == j.stats["tokens"]


def test_engine_over_a_mesh_equals_no_mesh_and_reference(lm_setup):
    """``RAGEngine(mesh=)`` passes the mesh to prefill and every decode
    step, as the reference's engine does: over a one-controller (1, 2)
    mesh the token streams equal the engine's without a mesh and the
    reference engine's (same smoke config and weights)."""
    jcfg, jp, cfg, params = lm_setup
    mesh = Mesh(np.array(["cpu"] * 2).reshape(1, 2), ("data", "model"))
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32), int(n))
            for L, n in zip(rng.integers(2, 14, 5), rng.integers(1, 8, 5))]
    j = JRAGEngine(jcfg, jp, None, JEngineConfig(n_slots=2, max_seq=MAX_SEQ))
    plain = _engine(cfg, params, n_slots=2)
    meshed = RAGEngine(cfg, params, None,
                       EngineConfig(n_slots=2, max_seq=MAX_SEQ), mesh,
                       device="cpu")
    assert meshed.mesh is mesh
    for eng in (j, plain, meshed):
        for i, (pr, n) in enumerate(reqs):
            eng.submit(i, pr, max_new_tokens=n)
    want = j.run_to_completion()
    assert plain.run_to_completion() == want
    assert meshed.run_to_completion() == want
    with pytest.raises(TypeError, match="Mesh"):
        RAGEngine(cfg, params, None, EngineConfig(), mesh="cpu",
                  device="cpu")


def test_embed_queries_matches_reference(lm_setup):
    jcfg, jp, cfg, params = lm_setup
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 7))
    j = JRAGEngine(jcfg, jp, None, JEngineConfig(n_slots=1, max_seq=MAX_SEQ))
    np.testing.assert_allclose(_engine(cfg, params).embed_queries(toks),
                               j.embed_queries(toks), rtol=0, atol=1e-6)


def test_engine_needs_a_device_or_an_explicit_cpu(lm_setup):
    _, _, cfg, params = lm_setup
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="live on"):
            RAGEngine(cfg, params, None, EngineConfig())
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGEngine(cfg, params, None, EngineConfig())


# ------------------------------------------------------------------ scheduler
class TestScheduler:
    def test_admit_evict_refill(self):
        b = ContinuousBatcher(2)
        for i in range(4):
            b.submit(Request(i, np.arange(3 + i), max_new_tokens=2 + i))
        assert b.admit() == [0, 1]
        assert b.slots[0].pos == 3 and b.slots[1].pos == 4
        assert b.admit() == []
        b.record_tokens(np.array([10, 11]))
        assert all(s.active for s in b.slots)
        b.record_tokens(np.array([12, 13]))
        assert not b.slots[0].active and b.slots[1].active
        assert b.requests[0].done and b.requests[0].generated == [10, 12]
        assert b.admit() == [0]
        assert b.slots[0].rid == 2
        assert b.any_active

    def test_pos_advances_per_slot(self):
        b = ContinuousBatcher(2)
        b.submit(Request(0, np.arange(2), max_new_tokens=5))
        b.submit(Request(1, np.arange(9), max_new_tokens=5))
        b.admit()
        b.record_tokens(np.array([1, 1]))
        assert (b.slots[0].pos, b.slots[1].pos) == (3, 10)

    def test_zero_token_never_takes_a_slot(self):
        b = ContinuousBatcher(1)
        b.submit(Request(0, np.arange(3), max_new_tokens=0))
        b.submit(Request(1, np.arange(3), max_new_tokens=2))
        assert b.admit() == [0]
        assert b.slots[0].rid == 1
        assert b.requests[0].done and b.requests[0].generated == []

    def test_prefill_token_counts_toward_budget(self):
        b = ContinuousBatcher(1)
        b.submit(Request(0, np.arange(3), max_new_tokens=1))
        (slot,) = b.admit()
        b.record_prefill_token(slot, 7)
        assert b.requests[0].done and b.requests[0].generated == [7]
        assert not b.slots[0].active

    def test_admission_token_bucket_and_bounded_queue(self):
        adm = AdmissionController({"a": TenantQuota(rate=1.0, burst=2.0)})
        assert adm.try_admit("a", now=0.0) and adm.try_admit("a", now=0.0)
        assert not adm.try_admit("a", now=0.0)
        assert adm.try_admit("a", now=1.0)            # refilled one token
        assert adm.try_admit("anyone", now=0.0)       # no quota: admitted
        b = ContinuousBatcher(1, max_queue=1)
        assert b.submit(Request(0, np.arange(2)))
        assert not b.submit(Request(1, np.arange(2)))
        assert b.requests[0].generated == [] and 1 not in b.requests


# ------------------------------------------------------------ index + engine
def _index_pair():
    c = make_corpus(n_nodes=N, modality_dims={"text": 32}, intra_p=96 / N,
                    inter_p=2 / N, seed=0)
    jcfg = jget_config("hmgi").replace(n_partitions=8, n_probe=3,
                                       kmeans_iters=4, delta_capacity=64,
                                       top_k=6, maint_auto=False)
    ji = JIndex(jcfg)
    ji.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, N,
              edges=(c.src, c.dst, c.edge_type))
    tree, meta = ji.state_tree()
    tree = {k: np.asarray(v) for k, v in tree.items()}
    pi = index_from_jax_state(tree, meta, "cpu",
                              cfg=HMGIConfig(**dataclasses.asdict(jcfg)))
    return c, ji, pi


@pytest.fixture(scope="module")
def index_pair():
    return _index_pair()


def _queries(c, n, seed):
    rng = np.random.default_rng(seed)
    v = c.vectors["text"]
    rows = rng.choice(v.shape[0], n, replace=False)
    return (v[rows] + 0.05 * rng.normal(size=(n, v.shape[1]))
            ).astype(np.float32)


def test_engine_refuses_maintenance_it_cannot_run(lm_setup):
    """Nothing is refused any more: maintenance is ported, so an engine
    with an index at the default ``maintenance_interval=4`` paces one
    bounded ``maintain`` pass (budget 256 rows) every 4th tick, and
    ``maintenance_interval=0`` turns it off."""
    _, _, cfg, params = lm_setup
    c, _, pi = _index_pair()               # fresh: the passes may act on it
    eng = _engine(cfg, params, pi)
    drv = eng.maintenance
    assert drv is not None and drv.interval == 4 and drv.budget_rows == 256
    rng = np.random.default_rng(4)
    for i in range(3):
        eng.submit(i, rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                   retrieved_ids=eng.retrieve(_queries(c, 1, seed=i))[0],
                   max_new_tokens=5)
    eng.run_to_completion()
    assert drv.ticks >= 4 and drv.runs == drv.ticks // 4
    assert eng.stats["maintenance_runs"] == drv.runs
    assert _engine(cfg, params, pi, maintenance_interval=0).maintenance is None


def test_rag_engine_serves_mla_moe_like_reference(index_pair):
    """DeepSeek-V2-Lite's smoke widths (MLA cache, a dense first layer,
    MoE with a shared expert, the default capacity factor, so a tick's
    slots share expert capacity) in the engine over the index, with
    maintenance paced every 4th tick as for phi4-mini: the same token
    streams as the JAX engine given the same retrievals."""
    jcfg, jp, cfg, params = _lm_pair("deepseek-v2-lite-16b")
    c, ji, _ = index_pair
    _, _, pi = _index_pair()               # fresh: the passes may act on it
    ecfg = dict(n_slots=3, max_seq=64, retrieve_k=4, hops=1)
    j = JRAGEngine(jcfg, jp, ji, JEngineConfig(**ecfg, maintenance_interval=0))
    p = _engine(cfg, params, pi, **ecfg)
    assert p.maintenance is not None and p.maintenance.interval == 4
    assert p._cache[0].shape == (cfg.n_layers, 3, 64, cfg.kv_lora_rank)
    ids = p.retrieve(_queries(c, 5, seed=8))
    rng = np.random.default_rng(9)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, 4 + 3 * i).astype(np.int32)
        for eng in (j, p):
            eng.submit(i, prompt, retrieved_ids=ids[i],
                       max_new_tokens=2 + i % 4)
    assert p.run_to_completion() == j.run_to_completion()
    assert p.stats["ticks"] == j.stats["ticks"] >= 4
    assert p.stats["maintenance_runs"] == p.stats["ticks"] // 4


def test_rag_engine_matches_reference_engine(lm_setup, index_pair):
    """Retrieval ids equal the JAX engine's up to score ties; the generated
    streams of requests built from them are identical."""
    jcfg, jp, cfg, params = lm_setup
    c, ji, pi = index_pair
    ecfg = dict(n_slots=4, max_seq=64, retrieve_k=4, hops=1,
                maintenance_interval=0)
    j = JRAGEngine(jcfg, jp, ji, JEngineConfig(**ecfg))
    p = _engine(cfg, params, pi, **ecfg)
    q = _queries(c, 4, seed=1)
    plan_kw = dict(k=4, n_hops=1)
    assert_topk_match(j_search_bucketed(ji, q, "text", **plan_kw),
                      search_bucketed(pi, q, "text", **plan_kw))
    jids, pids = j.retrieve(q), p.retrieve(q)
    assert pids.shape == jids.shape == (4, 4)
    rng = np.random.default_rng(2)
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        # each engine builds its prompt from its own retrieval
        j.submit(i, prompt, retrieved_ids=jids[i], max_new_tokens=3 + i % 3)
        p.submit(i, prompt, retrieved_ids=pids[i], max_new_tokens=3 + i % 3)
    for i in range(4):
        np.testing.assert_array_equal(p.batcher.requests[i].prompt,
                                      j.batcher.requests[i].prompt)
    assert p.run_to_completion() == j.run_to_completion()
    assert p.stats["retrievals"] == 4


# ----------------------------------------------------- bucketing + the cache
@pytest.mark.parametrize("nq", [1, 5])
@pytest.mark.parametrize("hops", [0, 1])
def test_search_bucketed_matches_solo_and_reference(index_pair, nq, hops):
    """A bucketed batch against Q solo calls: the same ids, scores to fp32
    rounding (what the port promises on the CPU); and against the
    reference's search_bucketed up to score ties."""
    c, ji, pi = index_pair
    q = _queries(c, nq, seed=10 + nq)
    sv, si = search_bucketed(pi, q, "text", k=6, n_hops=hops)
    assert sv.shape == si.shape == (nq, 6) and isinstance(sv, np.ndarray)
    solo = [search_bucketed(pi, q[i:i + 1], "text", k=6, n_hops=hops)
            for i in range(nq)]
    np.testing.assert_array_equal(si, np.concatenate([s[1] for s in solo]))
    np.testing.assert_allclose(sv, np.concatenate([s[0] for s in solo]),
                               rtol=0, atol=1e-6)
    assert_topk_match(j_search_bucketed(ji, q, "text", k=6, n_hops=hops),
                      (sv, si))


def test_cache_hit_miss_and_version_invalidation():
    c, _, pi = _index_pair()        # mutated below: its own copy
    cache = HotResultCache(capacity=4)
    svc = RetrievalService(pi, batching=False, cache=cache)
    plan = RetrievalPlan(modality="text", k=6)
    q = _queries(c, 2, seed=3)
    h0 = obs.counter("serving.cache.hit").value
    m0 = obs.counter("serving.cache.miss").value
    first = svc.search(plan, q[0])
    assert obs.counter("serving.cache.miss").value == m0 + 1
    second = svc.search(plan, q[0])
    assert obs.counter("serving.cache.hit").value == h0 + 1
    assert second[0].tobytes() == first[0].tobytes()
    assert second[1].tobytes() == first[1].tobytes()
    # a mutation bumps the version: the entry is evicted on sight
    v0 = pi.version
    rng = np.random.default_rng(0)
    pi.insert("text", np.array([N - 1], np.int32),
              rng.normal(size=(1, 32)).astype(np.float32))
    assert pi.version > v0
    i0 = obs.counter("serving.cache.invalidated").value
    fresh = svc.search(plan, q[0])
    assert obs.counter("serving.cache.invalidated").value == i0 + 1
    want = run_plan(pi, plan, q[:1])
    np.testing.assert_array_equal(fresh[1], want[1])
    # signature collisions miss; LRU eviction past capacity
    q1 = np.ones((1, 32), np.float32)
    q2 = q1 + np.float32(1e-4)
    assert query_signature(q1) == query_signature(q2)
    svc.search(plan, q1)
    assert cache.lookup(plan, q2, pi.version) is None
    for i in range(6):
        svc.search(plan, q[1] + i)
    assert len(cache) == 4


def test_search_many_and_micro_batcher_match_solo(index_pair):
    """search_many (one bucketed call for the misses) and 8 threads riding
    the MicroBatcher: each row's ids equal its solo call's."""
    c, _, pi = index_pair
    plan = RetrievalPlan(modality="text", k=6, n_hops=1)
    q = _queries(c, 8, seed=6)
    solo = [run_plan(pi, plan, q[i:i + 1]) for i in range(8)]
    svc = RetrievalService(pi, batching=True, window_s=0.01,
                           cache=HotResultCache(16))
    sv, si = svc.search_many(plan, q)
    np.testing.assert_array_equal(si, np.concatenate([s[1] for s in solo]))
    mb = MicroBatcher(pi, window_s=0.2)
    out = [None] * 8
    calls0 = obs.counter("serving.batch.calls").value

    def rider(i):
        out[i] = mb.search(plan, q[i])

    threads = [threading.Thread(target=rider, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        np.testing.assert_array_equal(out[i][1], solo[i][1])
        np.testing.assert_allclose(out[i][0], solo[i][0], rtol=0, atol=1e-6)
    assert obs.counter("serving.batch.calls").value - calls0 < 8


# ------------------------------------------------------------------------ obs
def test_obs_registry_matches_reference():
    """The port's obs copy records and exports exactly as the reference's."""
    vals = np.random.default_rng(0).exponential(3.0, 500)
    regs = (obs.metrics.MetricsRegistry(), jobs.metrics.MetricsRegistry())
    for reg in regs:
        for v in vals:
            reg.histogram("t.lat").observe(v)
        reg.counter("t.n").inc(3)
        reg.gauge("t.g").set(2.5)
    assert regs[0].to_dict() == regs[1].to_dict()
    assert obs.render_prometheus(regs[0]) == jobs.render_prometheus(regs[1])
    parsed = obs.parse_prometheus(obs.render_prometheus(regs[0]))
    assert parsed["counters"]["hmgi_t_n"] == 3


def test_span_fence_and_trace():
    obs.set_sync_spans(True)
    try:
        with obs.trace() as tr:
            with obs.span("t.outer"):
                with obs.span("t.inner") as sp:
                    x = sp.fence((torch.ones(3), [torch.zeros(2)]))
        assert isinstance(x, tuple)
    finally:
        obs.set_sync_spans(False)
    assert tr.find("t.inner") is not None
    assert tr.root.name == "t.outer" and tr.root.children[0].name == "t.inner"
