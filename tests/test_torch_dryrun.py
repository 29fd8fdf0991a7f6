"""The port's H100 dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

The reference's dry run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its side runs once, in a subprocess
(``tests/torch_dryrun_ref.py``), and this file reads what it wrote:

- **Parameter trees.** For every assigned arch at its published config,
  the tree the port's ``init`` builds on the meta device has the leaves of
  the reference's ``abstract_init``, shape and dtype, matched through
  ``convert.py``'s layout (a stacked layer's row is a list entry), and
  ``param_axes`` gives the reference's logical axes (without the stacked
  layer axis); GNN parameters are replicated, as the reference's dry run
  places them.
- **Per-device bytes** on (16, 16) and (2, 16, 16): parameters and AdamW
  state from the port's ``shard_tree`` equal the reference's.
- **Model FLOPs**: every non-skipped cell's equal the reference's
  ``build_cell`` metas (``_gnn_model_flops`` for every GNN arch and
  shape).
- **Collectives**: on a 4-shard CPU mesh the counter's per-device bytes
  and counts for ``psum``, ``all_gather`` and ``ppermute`` equal
  ``parse_collective_bytes`` / ``count_collective_ops`` on the HLO of the
  same ``shard_map`` program on four host devices.

And on the port alone: a GNN probe pair predicts a directly counted
mid-size run within 2%; the ``fits`` answers match ``PERF.md`` §4 for the
cells listed there that this host counts in the time (``FITS``); the recsys
``param_count`` gap of the reference is pinned; the records' layout.
"""
import pytest

pytest.importorskip("torch")

import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.common.tree import leaves
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shapes
from repro_torch.configs.base import GNNConfig, LMConfig, ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models.gnn import common
from repro_torch.roofline.trace import Counter, count_collective_ops
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import Mesh

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")


@pytest.fixture
def one_thread():
    """The GNN probes' many small CPU operators, in one thread: beside the
    other test workers a thread pool a worker only oversubscribes the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "torch_dryrun_ref.py"), str(out)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)) and not (
            tree and isinstance(tree[0], (str, type(None)))) and not (
            isinstance(tree, tuple) and len(tree) == 0):
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _ref_leaf(cfg, ref_leaves, path):
    """The reference leaf a port path reads (``convert.lm_params_from_jax``'s
    layout for an LM): (shape, dtype, axes)."""
    if isinstance(cfg, LMConfig) and path.startswith("/layers/"):
        _, _, i, rest = path.split("/", 3)
        i = int(i)
        if i < cfg.first_dense_layers:
            return ref_leaves[f"/head_layers/{i}/{rest}"]
        shape, dtype, axes = ref_leaves[f"/layers/{rest}"]
        return shape[1:], dtype, axes[1:]
    return ref_leaves[path]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_tree_and_axes_match_reference(ref, arch):
    cfg = get_config(arch)
    params = dryrun.init_params(cfg)
    assert all(t.device.type == "meta" for t in leaves(params))
    axes = _flat(dryrun.param_axes(cfg, params))
    got = {p: t for p, t in _flat(params).items()}
    want = ref["params"][arch]
    n_ref = 0
    for path, t in got.items():
        shape, dtype, ref_axes = _ref_leaf(cfg, want, path)
        assert list(t.shape) == shape, path
        assert str(t.dtype).removeprefix("torch.") == dtype, path
        if isinstance(cfg, GNNConfig):
            assert axes[path] == (None,) * t.dim(), path
        else:
            assert list(axes[path]) == ref_axes, path
    for path, (shape, _, _) in want.items():
        n_ref += int(np.prod(shape))
    assert dryrun.tree_numel(params) == n_ref


@pytest.mark.parametrize("mesh_name", ["singlepod", "multipod"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_per_device_bytes_match_reference(ref, arch, mesh_name):
    shape = next(s for s in get_shapes(arch) if not s.skip)
    rec = dryrun.grid_record(arch, shape, mesh_name)
    want = ref["per_device"][f"{arch}/{mesh_name}"]
    assert rec["param_bytes_per_device"] == want["params"]
    train = shape.kind in ("train", "full_graph", "molecule", "minibatch")
    assert train
    assert rec["opt_state_bytes_per_device"] == want["opt"]
    assert rec["devices"] == (512 if mesh_name == "multipod" else 256)
    for term in ("compute", "memory", "collective"):
        assert rec[term].startswith("not counted")
    assert rec["fits"] == (rec["state_bytes_per_device"] <= 80e9)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(ref, arch):
    cfg = get_config(arch)
    for shape in get_shapes(arch):
        if shape.skip:
            continue
        got = dryrun.model_meta(cfg, shape)["model_flops"]
        assert got == ref["model_flops"][f"{arch}/{shape.name}"], shape.name


def test_collective_bytes_match_the_hlo(ref):
    mesh = Mesh(["cpu"] * 4, ("data",))
    xs = [torch.ones(*ref["collectives"]["shard"]) for _ in range(4)]
    bodies = {
        "psum": lambda: col.psum(xs, mesh, "data"),
        "all_gather": lambda: col.all_gather(xs, mesh, "data"),
        "ppermute": lambda: col.rotate(xs, mesh, "data"),
    }
    assert set(bodies) == set(ref["collectives"]) - {"shard"}
    for name, body in bodies.items():
        with Counter() as c:
            body()
        want = ref["collectives"][name]
        got = c.summary()
        assert got["collective_bytes_per_device"] == want["bytes"], name
        assert count_collective_ops(c) == want["ops"], name
    # the ring's total: every shard sends its block once a rotation
    with Counter() as c:
        col.rotate(xs, mesh, "data")
    assert c.collective_total["collective-permute"] == 4 * xs[0].numel() * 4


def test_probe_pair_predicts_a_mid_size_run(one_thread):
    """EGNN at its published width on a 16,384-node graph cut into 8
    blocks and 2 chunks (the budgets scaled down so that the graph has
    several): the probes at 1/8 and 1/4 of it give the directly counted
    step within 2%."""
    cfg = get_config("egnn")
    shape = ShapeSpec("mid", "full_graph",
                      {"n_nodes": 16_384, "n_edges": 131_072, "d_feat": 16})
    with common.scaled_budgets(1 / 64):
        pred = dryrun.gnn_cell(cfg, shape, "cpu", probe_edges=1 << 15)
        direct = dryrun.gnn_probe(cfg, shape, 1.0, cfg.n_layers, "cpu")
    assert sorted({p["scale"] for p in pred["probes"]}) == [0.125, 0.25]
    for key in ("flops_total", "bytes", "peak_bytes"):
        assert pred[key] == pytest.approx(direct[key], rel=0.02), key
    for name, k in direct["kernels"].items():
        assert pred["kernels"][name]["launches"] == pytest.approx(
            k["launches"], rel=0.02), name


# PERF.md §4: the card runs these cells' step (train) or call at their full
# shape, so they fit; these it cuts for memory. The LM train cells at
# global batch 256 other than phi4-mini's, Equiformer-v2's three, and the
# others run at full shape are held on the card (``chip_smoke.py``'s
# dryrun phase), which counts them in minutes this host does not have.
FITS = [("xdeepfm", "train_batch", True), ("xdeepfm", "serve_p99", True),
        ("xdeepfm", "serve_bulk", True), ("xdeepfm", "retrieval_cand", True),
        ("egnn", "ogb_products", True), ("egnn", "minibatch_lg", True),
        ("egnn", "molecule", True), ("dimenet", "molecule", True),
        ("dimenet", "ogb_products", False),
        ("phi4-mini-3.8b", "train_4k", False)]
# smaller probes than the CPU's default where the answer allows: EGNN's
# peak is linear in the scale from 1/4,096 of ogbn-products on (its slope
# there equals the one at 1/512), and DimeNet's triplets' (T, 42) basis
# alone is 83 GB, whatever the probes' branch of the peak
PROBE_EDGES = {("egnn", "ogb_products"): 1 << 14,
               ("dimenet", "ogb_products"): 1 << 11}


@pytest.mark.parametrize("arch,shape_name,fits", FITS)
def test_fits_answers(arch, shape_name, fits, one_thread):
    shape = next(s for s in get_shapes(arch) if s.name == shape_name)
    rec = dryrun.h100_record(arch, shape, "cpu",
                             PROBE_EDGES.get((arch, shape_name)))
    assert rec["fits"] is fits, (rec["peak_bytes"], rec["assumptions"])
    if (arch, shape_name) == ("egnn", "ogb_products"):
        # the card's step peaks at 19.08 GiB (PERF.md §5)
        assert 15 * 2 ** 30 < rec["peak_bytes"] < 25 * 2 ** 30


def test_reference_recsys_param_count_gap_is_pinned():
    """The reference's ``RecsysConfig.param_count`` leaves out ``linear_w``
    (39 x 100,000 first-order weights): the tree holds 3,900,000 more
    (ROADMAP.md Queue 3). The dry run counts the tree."""
    from repro.configs import get_config as ref_config
    assert ref_config("xdeepfm").param_count() == 42_742_001
    cfg = get_config("xdeepfm")
    assert cfg.param_count() == 42_742_001
    shape = get_shapes("xdeepfm")[0]
    assert dryrun.state_record(cfg, shape)["params"] == 46_642_001


def test_records_layout(tmp_path):
    """One record per cell under ``<out>/<mesh>/``: a skipped LM shape with
    its reason, an ok cell with its roofline terms, decode_32k (a cache of
    2^32 elements, which the decode kernel takes) counted, and a cell the
    card's kernel check refuses recorded as failed with the check's
    message."""
    rc = dryrun.main(["--arch", "mixtral-8x7b", "--out", str(tmp_path),
                      "--cells", "traced", "--shape", "long_500k"])
    assert rc == 0
    rec = json.loads((tmp_path / "h100" /
                      "mixtral-8x7b__long_500k.json").read_text())
    assert rec["status"] == "ok" and rec["fits"] is False
    assert {"compute_s", "memory_s", "collective_s", "dominant", "bound_ms",
            "useful_ratio", "flops", "bytes", "peak_bytes", "params",
            "opt_state_bytes", "assumptions"} <= set(rec)
    assert rec["kernels"]["decode_attention"]["launches"] == 32
    phi = {s.name: s for s in get_shapes("phi4-mini-3.8b")}
    skip = dryrun.run_cell("phi4-mini-3.8b", phi["long_500k"], "h100")
    assert skip["status"] == "skipped" and skip["skip_reason"]
    d32 = dryrun.run_cell("phi4-mini-3.8b", phi["decode_32k"], "h100")
    assert d32["status"] == "ok"
    assert d32["kernels"]["decode_attention"]["launches"] == \
        get_config("phi4-mini-3.8b").n_layers
    fail = dryrun.failed_record("phi4-mini-3.8b", phi["decode_32k"], "h100",
                                ValueError("decode_attention: unsupported "
                                           "B=70000, S=32768"))
    assert dryrun.refused_by_kernel(fail)
