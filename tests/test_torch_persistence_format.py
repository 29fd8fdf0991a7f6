"""The port's durable files against the JAX package's, and the two repairs
that make recovery bit-identical.

Format (both ways, byte for byte where the bytes are defined by the op
stream alone):

- a snapshot and WAL written by the port are read by the reference's
  ``restore_checkpoint(like=None)`` and ``OpLog.scan``: equal arrays, meta,
  seq and checksums (and the other way for the exotic dtypes);
- both packages write byte-equal WAL segments for the same op script
  (``maint_auto=False``, no searches, so every heat stamp is zero);
- a data directory the reference wrote (a snapshot plus a tail of inserts
  and deletes, no random draw in the tail) is recovered by the port, whose
  searches equal the reference's recovered ones: scores to 1e-5 absolute,
  ids exactly where scores are distinct (``assert_topk_match``; the
  reference quantizes delta rows inside ``jax.jit``, so delta scores may
  differ in the last bits).

Repairs:

- a: a snapshot read back from disk keeps the generator state, so a random
  draw in the replayed tail (a split by ``maybe_repartition``) lands where
  the live run's did;
- b: ``partitioner.fit``'s cluster sums and the hop operator's out-weights
  go through the segment sum (fixed order on the card: ``run_sums``' two
  levels for the clusters, one CSR sum for the out-weights); on the CPU
  the bits equal the former ``index_add_`` ones.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import os
import shutil
import tempfile
import zlib

import ml_dtypes
import numpy as np
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint.checkpoint import save_checkpoint as j_save
from repro.configs.base import HMGIConfig as JConfig
from repro.persistence import DurableHMGIIndex as JDurable
from repro.persistence import recover as j_recover
from repro.persistence.oplog import OpLog as JOpLog
from repro.persistence.snapshot import config_fingerprint as j_fingerprint
from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs.base import HMGIConfig
from repro_torch.core import partitioner, traversal
from repro_torch.core.graph_store import from_edges
from repro_torch.persistence import DurableHMGIIndex, OpLog, recover
from repro_torch.persistence import crash_harness as ch
from repro_torch.persistence import faultpoints
from repro_torch.persistence.snapshot import (config_fingerprint,
                                              snapshot_dir, snapshot_steps,
                                              wal_dir)
from test_torch_ivf_topk import assert_topk_match

DEV = "cpu"


@pytest.fixture(autouse=True)
def _disarmed():
    faultpoints.disarm()
    yield
    faultpoints.disarm()


@pytest.fixture()
def tmpdir_():
    d = tempfile.mkdtemp(prefix="hmgi_format_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _jcfg(**kw):
    return JConfig(**{**dataclasses.asdict(ch.make_cfg()), **kw})


def _pcfg(jcfg):
    return HMGIConfig(**dataclasses.asdict(jcfg))


def test_config_fingerprints_equal():
    for jc in (_jcfg(), JConfig(), _jcfg(maint_auto=False, quant_bits=4)):
        assert config_fingerprint(_pcfg(jc)) == j_fingerprint(jc)


def _same_leaf(a, b):
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b)
    b = b.view(np.int16) if b.dtype == ml_dtypes.bfloat16 else b
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_port_files_read_by_reference(tmpdir_):
    cfg = ch.make_cfg()
    idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
    ch.apply_ops(idx, ch.scripted_ops())      # two snapshots and a tail
    idx.close()
    steps = snapshot_steps(tmpdir_)
    assert len(steps) == 2
    for step in steps:
        pt, pstep, pextra = restore_checkpoint(snapshot_dir(tmpdir_),
                                               like=None, step=step)
        jt, jstep, jextra = j_restore(snapshot_dir(tmpdir_), like=None,
                                      step=step)
        assert pstep == jstep == step and pextra == jextra
        assert list(pt) == list(jt)
        for k in pt:
            assert _same_leaf(pt[k], jt[k]), k
        # the manifest's checksums are the reference's over the same bytes
        with open(os.path.join(snapshot_dir(tmpdir_), f"step_{step:08d}",
                               "manifest.json")) as f:
            recs = json.load(f)["leaves"]
        for r in recs:
            assert r["crc32"] == zlib.crc32(np.ascontiguousarray(jt[r["key"]]))
    precs = list(OpLog(wal_dir(tmpdir_)).scan())
    jlog = JOpLog(wal_dir(tmpdir_))
    jrecs = list(jlog.scan())
    assert not jlog.torn_tail and len(precs) == len(jrecs) > 0
    for p, j in zip(precs, jrecs):
        assert (p.seq, p.op, p.meta) == (j.seq, j.op, j.meta)
        assert list(p.arrays) == list(j.arrays)
        for k in p.arrays:
            assert _same_leaf(p.arrays[k], j.arrays[k]), (p.seq, k)


def test_exotic_dtypes_cross_packages(tmpdir_):
    g = torch.Generator().manual_seed(1)
    bf = torch.randn((5, 3), generator=g).to(torch.bfloat16)
    save_checkpoint(os.path.join(tmpdir_, "p"), 1, {"w": bf})
    jt, _, _ = j_restore(os.path.join(tmpdir_, "p"), like=None)
    assert jt["w"].dtype == ml_dtypes.bfloat16 and _same_leaf(bf, jt["w"])
    j_save(os.path.join(tmpdir_, "j"), 1, {"w": np.asarray(jt["w"])})
    pt, _, _ = restore_checkpoint(os.path.join(tmpdir_, "j"), like=None)
    assert pt["w"].dtype == torch.bfloat16 and torch.equal(
        pt["w"].view(torch.int16), bf.view(torch.int16))
    log = OpLog(os.path.join(tmpdir_, "wal"))
    log.append("op", {}, {"w": bf, "i": np.arange(3, dtype=np.int64)})
    log.close()
    (rec,) = JOpLog(os.path.join(tmpdir_, "wal")).scan()
    assert _same_leaf(bf, rec.arrays["w"])
    assert rec.arrays["i"].tolist() == [0, 1, 2]


def _no_search(ops):
    return [e for e in ops if e[0] != "search"]


def test_wal_segments_byte_equal_across_packages(tmpdir_):
    jcfg = _jcfg(maint_auto=False)
    jdir, pdir = os.path.join(tmpdir_, "j"), os.path.join(tmpdir_, "p")
    j = JDurable(jcfg, jdir, seed=0)
    ch.apply_ops(j, _no_search(ch.scripted_ops()))
    j.close()
    p = DurableHMGIIndex(_pcfg(jcfg), pdir, seed=0, device=DEV)
    ch.apply_ops(p, _no_search(ch.scripted_ops()))
    p.close()
    jw, pw = sorted(os.listdir(wal_dir(jdir))), sorted(os.listdir(wal_dir(pdir)))
    assert jw == pw and len(jw) >= 2       # the snapshots rotated the log
    for name in jw:
        with open(os.path.join(wal_dir(jdir), name), "rb") as f:
            jb = f.read()
        with open(os.path.join(wal_dir(pdir), name), "rb") as f:
            pb = f.read()
        assert jb == pb, name


def test_reference_data_dir_recovered_by_port(tmpdir_):
    jcfg = _jcfg(maint_auto=False, use_nsw_refine=False, delta_capacity=128)
    rng = np.random.default_rng(5)
    n, d = 200, 12
    emb = {m: (np.arange(n, dtype=np.int32),
               rng.standard_normal((n, d)).astype(np.float32))
           for m in ("text", "image")}
    edges = (rng.integers(0, n, 500).astype(np.int32),
             rng.integers(0, n, 500).astype(np.int32))
    attrs = {"cat": rng.integers(0, 4, n).astype(np.int32)}
    j = JDurable(jcfg, tmpdir_, seed=0)
    j.ingest(emb, n, edges=edges, node_attrs=attrs)
    j.insert("text", np.arange(190, 210, dtype=np.int32),   # updates + new
             rng.standard_normal((20, d)).astype(np.float32))
    j.snapshot()
    j.insert("image", np.arange(0, 12, dtype=np.int32),
             rng.standard_normal((12, d)).astype(np.float32))
    j.delete("text", np.arange(5, 9, dtype=np.int32))
    j.insert("text", np.arange(210, 222, dtype=np.int32),
             rng.standard_normal((12, d)).astype(np.float32))
    j.delete("image", np.array([3, 150], dtype=np.int32))
    j.close()
    jr = j_recover(jcfg, tmpdir_, seed=0)
    assert "snapshot step 2 + 4 replayed ops" in jr.metrics()["recovery"]
    pr = recover(_pcfg(jcfg), tmpdir_, seed=0, device=DEV)
    assert pr.last_seq == jr.last_seq == 6
    assert "snapshot step 2 + 4 replayed ops" in pr.metrics()["recovery"]
    q = np.random.default_rng(9).standard_normal((6, d)).astype(np.float32)
    for mod in ("text", "image"):
        assert_topk_match(jr.search(q, mod, k=8), pr.search(q, mod, k=8))
        assert_topk_match(jr.search(q, mod, k=8, where=("cat", "==", 1)),
                          pr.search(q, mod, k=8, where=("cat", "==", 1)))
        assert_topk_match(jr.search(q, mod, k=8, n_probe=4),
                          pr.search(q, mod, k=8, n_probe=4))
        assert_topk_match(jr.hybrid_search(q, mod, k=8),
                          pr.hybrid_search(q, mod, k=8))
    jr.close()
    pr.close()


# ----------------------------------------------------------------- repair a
def test_prng_op_after_snapshot_recovers_bit_identical(tmpdir_):
    """A split drawn from the generator in the replayed tail: the snapshot
    read back from disk carries the generator state, so the recovered slab,
    centroids and searches equal the live index's byte for byte."""
    cfg = HMGIConfig(modalities=("text",), dim=16, n_partitions=8, n_probe=1,
                     kmeans_iters=4, delta_capacity=256, maint_auto=False)
    rng = np.random.default_rng(0)
    n = 2000
    v = rng.standard_normal((n, 16)).astype(np.float32)
    live = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
    live.ingest({"text": (np.arange(n, dtype=np.int32), v)}, n)
    live.snapshot()
    # probe heat on one partition only: imbalance K > the threshold 4
    hot_q = v[:1] + 0.01 * rng.standard_normal((64, 16)).astype(np.float32)
    live.search(hot_q, "text")
    assert live.maybe_repartition("text")
    live.insert("text", np.arange(n, n + 32, dtype=np.int32),
                rng.standard_normal((32, 16)).astype(np.float32))
    rec = recover(cfg, tmpdir_, seed=0, device=DEV)
    assert "snapshot step 1 + 2 replayed ops" in rec.metrics()["recovery"]
    a, b = live.modalities["text"], rec.modalities["text"]
    for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
        assert torch.equal(getattr(a.ivf, f), getattr(b.ivf, f)), f
    assert torch.equal(live.generator.get_state(), rec.generator.get_state())
    q = rng.standard_normal((16, 16)).astype(np.float32)
    for n_probe in (1, 8):
        ls, li = live.search(q, "text", n_probe=n_probe)
        rs, ri = rec.search(q, "text", n_probe=n_probe)
        assert ls.numpy().tobytes() == rs.numpy().tobytes()
        assert torch.equal(li, ri)
    live.close()
    rec.close()


def test_restore_state_generator_key_forms():
    from repro_torch.core.index import HMGIIndex
    cfg = HMGIConfig(modalities=("text",), dim=8, n_partitions=2)
    src = HMGIIndex(cfg, seed=3, device=DEV)
    src.ingest({"text": (np.arange(40), np.random.default_rng(1)
                         .standard_normal((40, 8)).astype(np.float32))}, 40)
    tree, meta = src.state_tree()
    want = src.generator.get_state()
    for key in (want, want.numpy()):        # in memory / read from disk
        dst = HMGIIndex(cfg, seed=0, device=DEV)
        dst.restore_state({**tree, "key": key}, meta)
        assert torch.equal(dst.generator.get_state(), want)
    # a reference JAX key reseeds from ``seed``
    dst = HMGIIndex(cfg, seed=0, device=DEV)
    dst.restore_state({**tree, "key": np.array([0, 3], np.uint32)}, meta)
    assert torch.equal(dst.generator.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    for bad in (None, np.arange(4, dtype=np.int64), 7):
        with pytest.raises(ValueError, match="key"):
            HMGIIndex(cfg, seed=0, device=DEV).restore_state(
                {**tree, "key": bad}, meta)


# ----------------------------------------------------------------- repair b
def _fit_index_add(x, k, n_iters, init_idx):
    """``partitioner.fit`` as it summed before: fp32 ``index_add_``."""
    cents = x[init_idx]
    counts = torch.zeros((k,))
    for _ in range(n_iters):
        a = partitioner.assign(x, cents).long()
        sums = torch.zeros_like(cents).index_add_(0, a, x)
        counts = torch.zeros((k,)).index_add_(0, a, torch.ones((x.shape[0],)))
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents, counts


@pytest.mark.parametrize("n,d,k", [(3000, 24, 16), (777, 384, 64), (50, 8, 4)])
def test_fit_cpu_bits_unchanged_by_segment_sum(n, d, k):
    g = torch.Generator().manual_seed(n)
    x = torch.randn((n, d), generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    init = torch.randperm(n, generator=g)[:k]
    st = partitioner.fit(x, k, 6, init_idx=init)
    cents, counts = _fit_index_add(x, k, 6, init)
    assert torch.equal(st.centroids, cents) and torch.equal(st.counts, counts)


@pytest.mark.parametrize("n,d,k", [(3000, 24, 16), (700, 8, 3), (9, 5, 4)])
def test_run_sums_two_level_order(n, d, k):
    """The card's cluster sums (``run_sums``, here through the plain
    version of the kernel): each cluster's rows in stable order, summed in
    runs of RUN_ROWS from 0, then the runs in order, all fp32 — bit for
    bit a loop that does exactly that; and within fp32 rounding of the
    float64 sums. Empty clusters sum to 0."""
    g = torch.Generator().manual_seed(n + k)
    x = torch.randn((n, d), generator=g)
    a = torch.randint(0, k, (n,), generator=g).to(torch.int32)
    a[a == k - 1] = 0                      # one empty cluster
    got = partitioner.run_sums(x, a, k)
    want = torch.zeros((k, d))
    run = partitioner.RUN_ROWS
    for c in range(k):
        rows = torch.nonzero(a == c).flatten()
        total = torch.zeros((d,))
        for s in range(0, rows.numel(), run):
            part = torch.zeros((d,))
            for r in rows[s:s + run]:
                part = part + x[r]
            total = total + part
        want[c] = total
    assert torch.equal(got, want)
    ref = torch.zeros((k, d), dtype=torch.float64).index_add_(
        0, a.long(), x.double())
    assert torch.allclose(got.double(), ref, rtol=0, atol=1e-4)


def test_push_operator_cpu_bits_unchanged_by_segment_sum():
    rng = np.random.default_rng(4)
    n, e = 300, 4000
    g = from_edges(n, rng.integers(0, n, e), rng.integers(0, n, e),
                   rng.integers(0, 3, e),
                   rng.random(e).astype(np.float32) + 0.1, device=DEV)
    for mask in (None, torch.tensor([True, False, True])):
        ew = traversal._edge_weights(g, mask)
        a = traversal._push_operator(g, ew)
        src = g.src.long()
        deg = torch.zeros((n,)).index_add_(0, src, ew)
        inv = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1e-12), 0.0)
        want = torch.sparse_coo_tensor(torch.stack([g.indices.long(), src]),
                                       inv[src] * ew, (n, n),
                                       check_invariants=False).coalesce()
        assert torch.equal(a.indices(), want.indices())
        assert torch.equal(a.values(), want.values())
