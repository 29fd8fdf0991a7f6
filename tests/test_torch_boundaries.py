"""The port's boundaries: it never imports JAX or the reference package,
its entry points default to the CUDA device, and calls that need an
unported part raise ``NotImplementedError`` instead of running something
else."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.index import HMGIIndex

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.index, repro_torch.convert\n"
        "import repro_torch.kernels.ivf_topk.ops, repro_torch.query.executor\n"
        "import repro_torch.data.synthetic\n"
        "import repro_torch.serving.engine, repro_torch.models.lm\n"
        "import repro_torch.kernels.decode_attention.ops, repro_torch.obs\n"
        "import repro_torch.kernels.segment_reduce.ops\n"
        "import repro_torch.models.gnn.driver, repro_torch.sparse.segment\n"
        "import repro_torch.maintenance.executor\n"
        "import repro_torch.core.nsw, repro_torch.core.rerank\n"
        "import repro_torch.core.progressive, repro_torch.core.learned\n"
        "import repro_torch.persistence.durable, repro_torch.checkpoint\n"
        "import repro_torch.persistence.crash_harness\n"
        "import repro_torch.sharding\n"
        "import repro_torch.common.tree, repro_torch.sparse.sampler\n"
        "import repro_torch.train.optimizer, repro_torch.train.trainer\n"
        "import repro_torch.runtime.fault\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", f"port imported: {r.stdout.strip()}"


def test_default_device_is_the_card():
    """No device given means CUDA: it raises on a host without one."""
    cfg = get_config("hmgi")
    if torch.cuda.is_available():
        assert HMGIIndex(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HMGIIndex(cfg)
    assert HMGIIndex(cfg, device="cpu").device.type == "cpu"


def _small_index(maint_auto=False):
    cfg = get_config("hmgi").replace(n_partitions=4, n_probe=2,
                                     delta_capacity=32, maint_auto=maint_auto)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 16)).astype(np.float32)
    idx = HMGIIndex(cfg, device="cpu")
    idx.ingest({"text": (np.arange(64), v)}, 64,
               edges=(np.arange(63), np.arange(1, 64)))
    return idx, v


def test_unported_parts_raise():
    """The index takes a mesh (its row-sharded scan is ported); only the
    GNN ring over a mesh is still refused (item 15). The NSW lane, the
    rerank lane and traces run; unported configs are unknown."""
    from repro_torch.configs import get_config as pget
    from repro_torch.models.gnn.common import run_flat
    from repro_torch.models.gnn.driver import full_graph_loss
    from repro_torch.sharding import Mesh
    idx, v = _small_index(maint_auto=True)
    mesh = Mesh(["cpu"] * 2, ("data",))
    sharded = HMGIIndex(idx.cfg.replace(shard_layout="sharded"), mesh=mesh,
                        device="cpu")
    assert sharded.mesh is mesh and sharded.device.type == "cpu"
    assert idx.device_layout("text").layout == "single"
    with pytest.raises(TypeError, match="Mesh"):
        HMGIIndex(idx.cfg, mesh=object(), device="cpu")
    for call in (lambda: run_flat(None, None, None, mesh=mesh),
                 lambda: full_graph_loss(pget("egnn"), None, None,
                                         mesh=mesh)):
        with pytest.raises(NotImplementedError, match="item 15"):
            call()
    assert len(idx.search(v[:2], "text", trace=True)) == 3
    assert idx.hybrid_search(v[:2], "text", use_rerank=True)[1].shape == (2, 10)
    nsw = HMGIIndex(idx.cfg.replace(use_nsw_refine=True, nsw_degree=4),
                    device="cpu")
    nsw.ingest({"text": (np.arange(64), v)}, 64)
    assert nsw.modalities["text"].nsw.neighbors.shape == (64, 4)
    # every LM config is registered; the other GNN and recsys
    # configs wait for item 17
    assert get_config("qwen2-72b").qkv_bias
    for arch in ("dimenet", "xdeepfm"):
        with pytest.raises(KeyError, match="item 17"):
            get_config(arch)


def test_converter_refuses_nsw_and_sparse_state():
    """Named for what it checked before the NSW lane and the rerank lane
    were ported: the converter now carries both across, with the
    partition statistics."""
    from repro_torch.convert import index_from_jax_state
    from repro_torch.core.rerank import SparseVectors
    cfg = get_config("hmgi").replace(n_partitions=4, n_probe=2,
                                     delta_capacity=32, maint_auto=False,
                                     use_nsw_refine=True, nsw_degree=4)
    v = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    idx = HMGIIndex(cfg, device="cpu")
    idx.ingest({"text": (np.arange(64), v)}, 64,
               edges=(np.arange(63), np.arange(1, 64)))
    rng = np.random.default_rng(3)
    idx.set_sparse_docs(SparseVectors(rng.integers(-1, 50, (64, 6)),
                                      rng.random((64, 6))))
    tree, meta = idx.state_tree()
    tree = {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}
    assert meta["modalities"]["text"]["nsw"] and meta["sparse_docs"]
    back = index_from_jax_state(tree, meta, "cpu", cfg=idx.cfg)
    for a, b in zip(back.modalities["text"].nsw, idx.modalities["text"].nsw):
        assert torch.equal(a, b)
    for a, b in zip(back.sparse_docs, idx.sparse_docs):
        assert torch.equal(a, b)
    # partition statistics carry over
    dead = np.arange(4, dtype=np.int64)
    back = index_from_jax_state({**tree, "m/text/stats/dead": dead},
                                meta, "cpu", cfg=idx.cfg)
    np.testing.assert_array_equal(back.modalities["text"].stats.dead, dead)
    q = np.random.default_rng(1).normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_array_equal(back.search(q, "text")[1].numpy(),
                                  idx.search(q, "text")[1].numpy())


def test_core_exports_the_facade():
    """The reference's idiom ``from repro.core import HMGIIndex`` works on
    the port's package too."""
    from repro_torch.core import HMGIIndex as H, ModalityIndex, NodeAttributes
    from repro_torch.core.graph_store import NodeAttributes as N
    from repro_torch.core.index import ModalityIndex as M
    assert H is HMGIIndex and ModalityIndex is M and NodeAttributes is N
    import repro_torch.core as core
    with pytest.raises(AttributeError):
        core.NoSuchName


def test_default_config_writes_and_maintains():
    """``get_config("hmgi")`` (maint_auto on) inserts, updates, deletes,
    maintains and repartitions."""
    idx, v = _small_index(maint_auto=True)
    rng = np.random.default_rng(2)
    new = rng.normal(size=(40, 16)).astype(np.float32)
    idx.insert("text", np.arange(30, 70) % 64, new)
    idx.delete("text", [1, 2])
    assert not idx.maintain("text", budget=4096, need_rows=1).is_noop
    got = idx.search(new[:8], "text", k=1, n_probe=4)[1].numpy()[:, 0]
    np.testing.assert_array_equal(got, np.arange(30, 38))
    gone = idx.search(v[1:3], "text", k=10, n_probe=4)[1].numpy()
    assert not np.isin(gone, [1, 2]).any()
    assert "maintenance" in idx.metrics()
    # a skewed probe load on one of 8 partitions splits it
    idx = HMGIIndex(idx.cfg.replace(n_partitions=8), device="cpu")
    idx.ingest({"text": (np.arange(64), v)}, 64)
    m = idx.modalities["text"]
    m.workload.hits[:] = 0
    m.workload.hits[int(np.argmax(m.ivf.counts.numpy()))] = 1000
    assert idx.maybe_repartition("text")
    got = idx.search(v, "text", k=1, n_probe=8)[1].numpy()[:, 0]
    np.testing.assert_array_equal(got, np.arange(64))
