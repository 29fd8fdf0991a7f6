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
    idx, v = _small_index(maint_auto=True)
    for call in (lambda: idx.set_sparse_docs(None),
                 lambda: idx.device_layout("text"),
                 lambda: idx.search(v[:2], "text", trace=True),
                 lambda: idx.hybrid_search(v[:2], "text", use_rerank=True),
                 lambda: HMGIIndex(idx.cfg, mesh=object(), device="cpu"),
                 lambda: HMGIIndex(idx.cfg.replace(use_nsw_refine=True),
                                   device="cpu").ingest(
                     {"text": (np.arange(64), v)}, 64)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(KeyError):
        get_config("qwen2-72b")


def test_converter_refuses_nsw_and_sparse_state():
    from repro_torch.convert import index_from_jax_state
    idx, _ = _small_index()
    tree, meta = idx.state_tree()
    tree = {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}
    for extra in ("m/text/nsw/vectors", "sparse/term_ids"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            index_from_jax_state({**tree, extra: np.zeros(1)}, meta, "cpu")
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
