"""The port's sparse-dense rerank (``repro_torch.core.rerank``) and the
facade's ``use_rerank`` lane against the reference's ``repro.core.rerank``.

Tolerances: ``hash_terms`` exactly (integer hashing, wrapped to 32 bits as
the reference's uint32 product); ``sparse_overlap_scores`` within 1e-6
(sums of ≤ nnz·T products of O(1) weights, in another order);
``rrf_rerank`` ids exactly and RRF values within 1e-7 (ranks are integers
from stable argsorts, the values 1/(60 + rank) sums); the facade's
reranked ``hybrid_search`` ids up to ties of its RRF values and values
within 1e-6, on an index carried from the reference with
``convert.index_from_jax_state`` (sparse documents included).
"""
import pytest

pytest.importorskip("torch")

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from repro.core import rerank as jrerank
from repro_torch.core import rerank as prerank
from test_torch_ivf_topk import assert_topk_match


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _docs(rng, n, nnz, buckets):
    ids = rng.integers(0, buckets, (n, nnz)).astype(np.int32)
    ids[rng.random((n, nnz)) < 0.25] = -1
    w = rng.random((n, nnz)).astype(np.float32)
    return ids, w


@pytest.mark.parametrize("n_buckets", [97, 1 << 12, 1 << 16])
def test_hash_terms_equals_reference(n_buckets):
    rng = np.random.default_rng(n_buckets)
    tok = np.concatenate([rng.integers(0, 2 ** 31 - 1, 500),
                          [0, 1, 2 ** 31 - 1, -1, -7, -(2 ** 31)]]).astype(
        np.int32)
    want = np.asarray(jrerank.hash_terms(jnp.asarray(tok), n_buckets))
    got = prerank.hash_terms(_t(tok), n_buckets).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("nnz,t", [(8, 4), (32, 16)])
def test_sparse_overlap_scores_match_reference(nnz, t):
    rng = np.random.default_rng(nnz)
    ids, w = _docs(rng, 200, nnz, 64)
    q_terms = rng.integers(0, 64, t).astype(np.int32)
    q_w = rng.random(t).astype(np.float32)
    cand = rng.integers(-1, 200, (6, 30)).astype(np.int32)
    want = jrerank.sparse_overlap_scores(
        jrerank.SparseVectors(jnp.asarray(ids), jnp.asarray(w)),
        jnp.asarray(q_terms), jnp.asarray(q_w), jnp.asarray(cand))
    got = prerank.sparse_overlap_scores(
        prerank.SparseVectors(_t(ids), _t(w)), _t(q_terms), _t(q_w),
        _t(cand))
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got.numpy()))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,ties", [(10, False), (40, False), (10, True)])
def test_rrf_rerank_matches_reference(k, ties):
    rng = np.random.default_rng(k)
    dense = rng.normal(size=(5, 30)).astype(np.float32)
    sparse = rng.random((5, 30)).astype(np.float32)
    if ties:
        dense = np.round(dense, 1)
        sparse = np.floor(sparse * 3)
    cand = rng.permutation(60)[:30].astype(np.int32)[None].repeat(5, 0)
    cand[:, -4:] = -1
    dense[:, -4:] = -np.inf
    want = jrerank.rrf_rerank(jnp.asarray(dense), jnp.asarray(sparse),
                              jnp.asarray(cand), k=k)
    got = prerank.rrf_rerank(_t(dense), _t(sparse), _t(cand), k=k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def rerank_pair():
    from repro.configs import get_config as jget_config
    from repro.core.index import HMGIIndex as JIndex
    from repro.data.synthetic import make_corpus
    from repro_torch.configs.base import HMGIConfig
    from repro_torch.convert import index_from_jax_state
    n = 600
    c = make_corpus(n_nodes=n, modality_dims={"text": 32}, intra_p=60 / n,
                    inter_p=2 / n, seed=3)
    jcfg = jget_config("hmgi").replace(n_partitions=8, n_probe=3,
                                       kmeans_iters=4, delta_capacity=64,
                                       maint_auto=False)
    ji = JIndex(jcfg)
    ji.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, n,
              edges=(c.src, c.dst, c.edge_type))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 50_000, (n, 32)).astype(np.int32)
    term_ids = np.asarray(jrerank.hash_terms(jnp.asarray(tok), 1 << 12))
    ji.set_sparse_docs(jrerank.SparseVectors(
        jnp.asarray(term_ids), jnp.asarray(rng.random((n, 32)), jnp.float32)))
    tree, meta = ji.state_tree()
    assert meta["sparse_docs"]
    pi = index_from_jax_state({k: np.asarray(v) for k, v in tree.items()},
                              meta, "cpu",
                              cfg=HMGIConfig(**dataclasses.asdict(jcfg)))
    return ji, pi, c, tok


@pytest.mark.parametrize("n_hops", [1, 2])
def test_facade_rerank_matches_reference(rerank_pair, n_hops):
    ji, pi, c, tok = rerank_pair
    rng = np.random.default_rng(n_hops)
    q = c.vectors["text"][:8] + 0.05 * rng.normal(size=(8, 32)).astype(
        np.float32)
    # the batch's terms: 16 tokens of the first query's document
    q_terms = np.asarray(jrerank.hash_terms(jnp.asarray(tok[0, :16]), 1 << 12))
    q_w = rng.random(16).astype(np.float32)
    kw = dict(k=10, n_hops=n_hops, use_rerank=True, q_terms=q_terms,
              q_term_weights=q_w)
    want = ji.hybrid_search(q, "text", **kw)
    got = pi.hybrid_search(q, "text", **kw)
    assert_topk_match(want, got, atol=1e-6)
    # the lane ran: the plain fused order differs
    plain = pi.hybrid_search(q, "text", k=10, n_hops=n_hops)
    assert not np.array_equal(plain[1].numpy(), got[1].numpy())


def test_set_sparse_docs_round_trips_and_bumps_version(rerank_pair):
    from repro_torch.core.index import HMGIIndex
    _, pi, _, _ = rerank_pair
    v0 = pi.version
    docs = pi.sparse_docs
    pi.set_sparse_docs(prerank.SparseVectors(docs.term_ids.numpy(),
                                             docs.term_weights.numpy()))
    assert pi.version == v0 + 1
    assert pi.sparse_docs.term_ids.dtype == torch.int32
    tree, meta = pi.state_tree()
    back = HMGIIndex(pi.cfg, device="cpu")
    back.restore_state(tree, meta)
    assert torch.equal(back.sparse_docs.term_ids, docs.term_ids)
    assert torch.equal(back.sparse_docs.term_weights, docs.term_weights)
