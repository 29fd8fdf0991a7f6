"""The port's DimeNet, NequIP and Equiformer-v2 against the JAX package's,
on the CPU, at ``smoke_config``: twins of ``tests/test_gnn.py``'s forward,
rotation-invariance and train-step cases, logits against the reference
with its weights (``convert.gnn_params_from_jax``), DimeNet's triplet
builder, forward bits independent of the chunk budget, the engine's
sizing. One AdamW step against the reference's, the molecule batch with
triplets against its ``vmap`` and steps' bits:
``test_torch_gnn_models_train.py``.

Tolerances: logits, loss sums and new params within 1e-5 ·
max(1, max |want|) (fp32 products and sums in another order over two
layers: the tensor product, the Wigner-D blocks and the bilinear layer
are each summed in another order than the reference's einsums); the
triplet arrays exactly; the rotation invariance 1e-4 relative, as
``tests/test_gnn.py`` holds the reference to it.
"""
import pytest

pytest.importorskip("torch")

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models.gnn import dimenet as j_dimenet
from repro.models.gnn import driver as jd
from repro.sparse import sampler as j_sampler
from repro_torch.common import tree as t_tree
from repro_torch.configs import get_config, get_shapes, smoke_config
from repro_torch.configs.base import GNNConfig
from repro_torch.convert import gnn_params_from_jax
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn import dimenet as t_dimenet
from repro_torch.models.gnn import driver as td
from repro_torch.models.gnn import equiformer_v2, nequip
from repro_torch.models.gnn.common import FlatGraph, LocalExec
from repro_torch.sparse.segment import gather_rows
from repro_torch.train import optimizer as t_opt

ARCHS = ["dimenet", "nequip", "equiformer-v2"]


def _rel_tol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=_rel_tol(want))


def _port(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port_graph(g) -> FlatGraph:
    return FlatGraph(*(_port(x) for x in g))


def _models(arch, d_feat=8, n_out=jd.N_CLASSES, seed=0):
    jc, tc = j_smoke_config(arch), smoke_config(arch)
    params, _ = jd.init_model(jc, jax.random.PRNGKey(seed), d_feat, n_out)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, tp


def _masked(g):
    """The 60-node graph with every 4th edge and every 7th node masked and
    every 9th destination out of range."""
    em = np.ones(200, bool)
    em[::4] = False
    nm = np.ones(60, bool)
    nm[::7] = False
    dst = np.array(g.edge_dst)
    dst[1::9] = 75
    return g._replace(edge_mask=jnp.asarray(em), node_mask=jnp.asarray(nm),
                      edge_dst=jnp.asarray(dst))


def _trips(cfg, g):
    """(reference triplets, port triplets) of one graph, or Nones."""
    if cfg.model != "dimenet":
        return None, None
    arrays = (np.asarray(g.edge_src), np.asarray(g.edge_dst),
              np.asarray(g.edge_mask))
    return (j_dimenet.build_triplets(*arrays),
            t_dimenet.build_triplets(*arrays, device="cpu"))


def _batch_trips(cfg, jb):
    """A molecule batch's (B, T) triplets on both sides, or Nones."""
    if cfg.model != "dimenet":
        return None, None
    arrays = (np.asarray(jb.edge_src), np.asarray(jb.edge_dst),
              np.asarray(jb.edge_mask))
    tt = t_dimenet.build_batch_triplets(*arrays, device="cpu")
    return j_dimenet.TripletIndex(*(jnp.asarray(t.numpy()) for t in tt)), tt


@pytest.fixture(scope="module")
def graph():
    return jd.make_flat_graph(60, 200, 8, seed=0)


def _minibatch(seed=0, b=6, fanouts=(3, 2)):
    rng = np.random.default_rng(seed)
    n, e = 200, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[dst < 20] = 20                 # nodes 0..19 have no in-neighbours
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, jd.N_CLASSES, n)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    batch = j_sampler.NeighborSampler(n, src, dst, feats, labels,
                                      seed=seed).sample(
        np.arange(10, 10 + b), fanouts)
    safe = np.clip(batch.nodes, 0, n - 1)
    from repro.models.gnn.common import FlatGraph as JFlatGraph
    g = JFlatGraph(
        feats=jnp.asarray(batch.feats),
        positions=jnp.asarray(pos[safe] * (batch.nodes >= 0)[..., None]),
        edge_src=jnp.asarray(batch.edge_src),
        edge_dst=jnp.asarray(batch.edge_dst),
        edge_mask=jnp.asarray(batch.edge_mask),
        node_mask=jnp.asarray(batch.nodes >= 0),
        labels=jnp.zeros(batch.nodes.shape, jnp.int32))
    return g, jnp.asarray(batch.labels)


def _batches(kind, cfg):
    """(reference batch, port batch, d_feat, n_out) of one layout."""
    if kind == "full_graph":
        g = _masked(jd.make_flat_graph(60, 200, 8, seed=0))
        jt, tt = _trips(cfg, g)
        return ({"graph": g, "triplets": jt},
                {"graph": _port_graph(g), "triplets": tt}, 8, jd.N_CLASSES)
    if kind == "molecule":
        jb, je = jd.make_molecule_batch(4, 10, 24, seed=0)
        nm = np.ones((4, 10), bool)
        nm[2, 7:] = False
        jb = jb._replace(node_mask=jnp.asarray(nm))
        jt, tt = _batch_trips(cfg, jb)
        return ({"graph": jb, "energy": je, "triplets": jt},
                {"graph": _port_graph(jb), "energy": _port(je),
                 "triplets": tt}, 4, 1)
    g, labels = _minibatch()
    return ({"graph": g, "labels": labels},
            {"graph": _port_graph(g), "labels": _port(labels)}, 6,
            jd.N_CLASSES)


# ------------------------------------------------------------ configs, params
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    ref = j_get_config(arch)
    assert GNNConfig(**dataclasses.asdict(ref)) == get_config(arch)
    assert (GNNConfig(**dataclasses.asdict(j_smoke_config(arch)))
            == smoke_config(arch))
    assert ([(s.name, s.kind, s.dims) for s in get_shapes(arch)]
            == [(s.name, s.kind, s.dims) for s in get_shapes("egnn")])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_to_the_same_layout(arch):
    """The port's init has the reference's tree (keys and shapes, at the
    published config), and the converter carries every leaf bit for bit,
    DimeNet's 3-D ``w_bilinear`` and Equiformer's ``so2_m{m}_{r,i}``
    included."""
    jc = j_get_config(arch)
    params, _ = jd.init_model(jc, jax.random.PRNGKey(0), 8)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    mine = td.init_model(get_config(arch), 0, 8, device="cpu")
    paths = jax.tree_util.tree_leaves_with_path(params)
    assert len(t_tree.leaves(tp)) == len(t_tree.leaves(mine)) == len(paths)
    for path, leaf in paths:
        a, b = tp, mine
        for p in path:
            k = getattr(p, "key", getattr(p, "idx", None))
            a, b = a[k], b[k]
        assert a.dtype == b.dtype == torch.float32
        assert tuple(b.shape) == tuple(a.shape) == leaf.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(leaf))
    if arch == "dimenet":
        assert tuple(tp["blocks"][0]["w_bilinear"].shape) == (128, 8, 128)
    if arch == "equiformer-v2":
        assert {"so2_m0", "so2_m1_r", "so2_m1_i", "so2_m2_r",
                "so2_m2_i"} <= set(tp["layers"][0])
        assert tuple(tp["layers"][0]["so2_m2_r"].shape) == (640, 640)


# ------------------------------------------------- twins of tests/test_gnn.py
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_finite(arch, graph):
    cfg = smoke_config(arch)
    params = td.init_model(cfg, 0, 8, device="cpu")
    _, tt = _trips(cfg, graph)
    logits = td.node_logits_local(cfg, params, _port_graph(graph), tt)
    assert logits.shape == (60, td.N_CLASSES)
    assert bool(torch.all(torch.isfinite(logits)))


@pytest.mark.parametrize("arch", ARCHS)
def test_rotation_invariance(arch, graph):
    cfg = smoke_config(arch)
    params = td.init_model(cfg, 1, 8, device="cpu")
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    R = torch.from_numpy(Q.astype(np.float32))
    _, t = _trips(cfg, graph)
    tg = _port_graph(graph)
    l1 = td.node_logits_local(cfg, params, tg, t)
    l2 = td.node_logits_local(
        cfg, params, tg._replace(positions=tg.positions @ R.T), t)
    rel = float((l1 - l2).abs().max() / (l1.abs().max() + 1e-9))
    assert rel < 1e-4, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_runs(arch, graph):
    cfg = smoke_config(arch)
    params = td.init_model(cfg, 0, 8, device="cpu")
    step = td.make_train_step(cfg, "full_graph")
    _, tt = _trips(cfg, graph)
    p, o, m = step(params, t_opt.init_adamw(params),
                   {"graph": _port_graph(graph), "triplets": tt})
    assert np.isfinite(float(m["loss"]))
    assert bool(t_tree.tree_finite(p))


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_node_logits_match_reference(arch, masked, graph):
    g = _masked(graph) if masked else graph
    jc, tc, params, tp = _models(arch)
    jt, tt = _trips(jc, g)
    want = np.asarray(jax.jit(
        lambda p, g, t: jd.node_logits_local(jc, p, g, t))(params, g, jt))
    got = td.node_logits_local(tc, tp, _port_graph(g), tt)
    assert got.shape == (60, td.N_CLASSES)
    _close(got, want)


@pytest.mark.parametrize("seed,cap", [(0, 8), (1, 2), (2, 1), (3, 8)])
def test_build_triplets_equals_reference(seed, cap):
    """Random multigraphs with masked edges, duplicate edges, self-loops
    and back edges (k = i): the three arrays equal the reference's."""
    rng = np.random.default_rng(seed)
    n, e = 25, 160
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[:20], dst[:20] = src[20:40], dst[20:40]          # duplicates
    src[40:50], dst[40:50] = dst[50:60], src[50:60]      # back edges
    dst[60:64] = src[60:64]                              # self-loops
    mask = rng.random(e) > 0.2
    if seed == 3:
        mask[:] = False                                  # no triplet at all
    want = j_dimenet.build_triplets(src, dst, mask, cap)
    got = t_dimenet.build_triplets(src, dst, mask, cap, device="cpu")
    for a, b in zip(want, got):
        assert b.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert len(got.t_src) % 8 == 0 and len(got.t_src) >= 8
    # sorted by the edge ji, as the segment sum's CSR is built
    live = got.t_dst[got.t_mask]
    assert bool((live[1:] >= live[:-1]).all())


# ----------------------------------------------------- bits and the engine
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_is_bitwise_independent_of_chunk_budget(arch, graph,
                                                        monkeypatch):
    """Blocks of 16 edges; chunk budgets from one edge to the whole graph
    give the same logits, bit for bit."""
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 16)
    jc, tc, _, tp = _models(arch)
    g = _port_graph(_masked(graph))
    _, tt = _trips(jc, _masked(graph))
    outs = [td.node_logits_local(tc, tp, g, tt, ex=LocalExec(g, b))
            for b in (1, 10, 10 ** 9)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_sized_engine_at_the_published_widths():
    """A declared width sizes the block and the chunks; EGNN's engine
    keeps its sizes."""
    g = td.make_flat_graph(300, 100_000, 4, seed=0, device="cpu")
    ex = LocalExec(g, 1 << 22)
    assert ex.block == 1 << 17 and ex.chunk_edges == 1 << 22
    eq = equiformer_v2.engine(get_config("equiformer-v2"), ex)
    assert eq.block == 1 << 16 and eq.chunk_edges == (1 << 30) // (4 * 6272)
    assert len(eq.chunks) == 3 and eq.chunks[-1][1] == 300
    nq = nequip.engine(get_config("nequip"), ex)
    assert nq.block == 1 << 17 and nq.chunk_edges == (1 << 30) // (4 * 289)
    assert ex.block == 1 << 17 and len(ex.chunks) == 1     # unchanged
    assert eq.src is ex.src and eq.rowptr is ex.rowptr     # one sort
    # the driver's engine: each model's own sizing (EGNN's and DimeNet's
    # the defaults)
    for arch, want in (("egnn", ex), ("dimenet", ex), ("nequip", nq),
                       ("equiformer-v2", eq)):
        got = td.engine(get_config(arch), g, 1 << 22)
        assert (got.block, got.chunk_edges) == (want.block, want.chunk_edges)


def test_gather_rows_transpose_equals_index_add():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(30, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, 200).astype(np.int32))
    cot = torch.from_numpy(rng.normal(size=(200, 5)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(gather_rows(t, idx), t, cot)
    want = torch.zeros(30, 5).index_add_(0, idx.long(), cot)
    assert torch.equal(g, want)
    assert torch.equal(gather_rows(table, idx), table[idx.long()])
