"""The port's EGNN inference slice against the JAX package's, on the CPU.

Both sides get the same graphs (the builders draw from the same numpy
seed) and the same weights (the reference's ``init_model``, carried over
by ``convert.gnn_params_from_jax``). On the CPU the port's aggregation runs
the segment-sum kernel's plain version; the reference runs ``jax.ops``.

Tolerance of logits and loss sums: max |Δ| ≤ 1e-5 · max(1, max |logits|):
fp32 matmuls and sums in another order over 2-4 layers.
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
from repro.models.gnn import common as j_common
from repro.models.gnn import driver as jd
from repro_torch.configs import get_config, get_shapes, smoke_config
from repro_torch.configs.base import GNNConfig
from repro_torch.convert import gnn_params_from_jax
from repro_torch.kernels.segment_reduce import ops
from repro_torch.models.gnn import driver as td
from repro_torch.models.gnn.common import FlatGraph, LocalExec, chunk_bounds
from repro_torch.sharding import Mesh

_CFGS = {"smoke": (j_smoke_config, smoke_config),
         "full": (j_get_config, get_config)}


def _rel_tol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


def _masked(g):
    """The 60-node graph with every 4th edge and every 7th node masked."""
    em = np.ones(200, bool)
    em[::4] = False
    nm = np.ones(60, bool)
    nm[::7] = False
    return g._replace(edge_mask=jnp.asarray(em), node_mask=jnp.asarray(nm))


def _to_port(g) -> FlatGraph:
    return FlatGraph(*(torch.from_numpy(np.array(x, copy=True))
                       for x in g))


def _models(which: str, d_feat: int = 8, n_out: int = jd.N_CLASSES, seed=0):
    j_cfg_fn, t_cfg_fn = _CFGS[which]
    jc, tc = j_cfg_fn("egnn"), t_cfg_fn("egnn")
    params, _ = jd.init_model(jc, jax.random.PRNGKey(seed), d_feat, n_out)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, tp


@pytest.fixture(scope="module")
def graph():
    return jd.make_flat_graph(60, 200, 8, seed=0)


def test_configs_match_reference():
    for name in ("egnn", "dimenet", "nequip", "equiformer-v2"):
        ref = j_get_config(name)
        assert GNNConfig(**dataclasses.asdict(ref)) == get_config(name)
        assert (GNNConfig(**dataclasses.asdict(j_smoke_config(name)))
                == smoke_config(name))
    shapes = {s.name: s.dims for s in get_shapes("egnn")}
    assert shapes["ogb_products"] == {"n_nodes": 2_449_029,
                                      "n_edges": 61_859_140, "d_feat": 100}
    assert shapes["molecule"] == {"n_nodes": 30, "n_edges": 64, "batch": 128}
    # the recsys config is a RecsysConfig, not a GNN's; unknown ids raise
    assert get_config("xdeepfm").family == "recsys"
    assert not isinstance(get_config("xdeepfm"), GNNConfig)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_graph_builders_match_reference(graph):
    tg = td.make_flat_graph(60, 200, 8, seed=0, device="cpu")
    for name, a, b in zip(graph._fields, graph, tg):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    jb, je = jd.make_molecule_batch(3, 10, 24, seed=2)
    tb, te = td.make_molecule_batch(3, 10, 24, seed=2, device="cpu")
    for name, a, b in zip(jb._fields, jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())


def test_params_convert_to_the_same_layout():
    jc, tc, params, tp = _models("full")
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    assert len(tp["layers"]) == jc.n_layers == 4
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["layers"][0]["phi_e"]["w0"].shape == (2 * 64 + 1, 64)


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_node_logits_match_reference(graph, which, masked):
    g = _masked(graph) if masked else graph
    jc, tc, params, tp = _models(which)
    want = np.asarray(jd.node_logits_local(jc, params, g))
    got = td.node_logits_local(tc, tp, _to_port(g))
    assert got.shape == (60, td.N_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_rel_tol(want))


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_full_graph_loss_sums_match_reference(graph, which):
    g = _masked(graph)
    jc, tc, params, tp = _models(which)
    want = jd.full_graph_loss(jc, params, g)
    got = td.full_graph_loss(tc, tp, _to_port(g))
    tol = _rel_tol(want["loss_sum"])
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= tol
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["count"]) == float(want["count"]) == 51.0


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_molecule_loss_matches_vmapped_reference(which):
    """The port's disjoint-union batch against the reference's vmap."""
    jc, tc, params, tp = _models(which, d_feat=4, n_out=1)
    jb, je = jd.make_molecule_batch(6, 10, 24, seed=0)
    nm = np.ones((6, 10), bool)
    nm[2, 7:] = False
    jb = jb._replace(node_mask=jnp.asarray(nm))
    want = jd.molecule_loss(jc, params, jb, je)
    tb = FlatGraph(*(torch.from_numpy(np.array(x, copy=True)) for x in jb))
    got = td.molecule_loss(tc, tp, tb, torch.from_numpy(np.array(je)))
    tol = _rel_tol(want["loss_sum"])
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= tol
    assert float(got["count"]) == 6.0
    # one graph alone gives the same prediction as inside the union
    one = FlatGraph(*(x[2] for x in tb))
    alone = float((td.node_logits_local(tc, tp, one)[:, 0]
                   * one.node_mask).sum())
    union = td.node_logits_local(tc, tp, td.disjoint_union(tb))[:, 0]
    inside = float((union.reshape(6, 10)[2] * one.node_mask).sum())
    assert abs(alone - inside) <= 1e-5 * max(1.0, abs(alone))


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_forward_is_bitwise_independent_of_chunk_size(graph, which):
    """Any chunk budget (one-edge and edge-free chunks, hubs larger than
    the budget) gives the bits of one whole-graph chunk: each output row is
    summed in one fixed order, and every msg_fn call has ``block`` rows."""
    _, tc, _, tp = _models(which)
    tg = _to_port(_masked(graph))
    whole = td.node_logits_local(tc, tp, tg, ex=LocalExec(tg, 10 ** 9))
    for budget in (1, 2, 5, 16, 64):
        ex = LocalExec(tg, budget)
        assert len(ex.chunks) > 1 and ex.block == 256
        # within budget, or one segment larger than it
        assert all(e1 - e0 <= budget or hi - lo == 1
                   for lo, hi, e0, e1, _ in ex.chunks)
        assert torch.equal(td.node_logits_local(tc, tp, tg, ex=ex), whole)


@pytest.mark.parametrize("budget", [1, 2, 3, 7, 64, 10 ** 9])
def test_push_is_bitwise_independent_of_chunk_size(graph, budget):
    """The aggregation alone, with a row-wise message of exact ops, for any
    budget (chunks of one edge and of no edges included)."""
    tg = _to_port(_masked(graph))
    payload = torch.from_numpy(np.random.default_rng(1).normal(
        size=(60, 5)).astype(np.float32))

    def msg_fn(s, d):
        return torch.cat([s * d, s - d, torch.ones_like(s[:, :1])], -1)

    ex = LocalExec(tg, budget)
    bounds = [lo for lo, *_ in ex.chunks] + [60]
    assert bounds == chunk_bounds(ex.rowptr.numpy().astype(np.int64), budget)
    got = ex.push(payload, msg_fn, 11)
    whole = LocalExec(tg, 10 ** 9).push(payload, msg_fn, 11)
    assert torch.equal(got, whole)
    # against the reference's masked unsorted form
    jg = j_common.LocalExec(_masked(jd.make_flat_graph(60, 200, 8, seed=0)))
    want = np.asarray(jg.push(jnp.asarray(payload.numpy()),
                              lambda s, d: jnp.concatenate(
                                  [s * d, s - d, jnp.ones_like(s[:, :1])], -1),
                              11))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert int(got[:, -1].sum()) == ex.n_edges == 150


def test_push_attn_gather_and_geometry_match_reference(graph):
    g = _masked(graph)
    jex, tex = j_common.LocalExec(g), LocalExec(_to_port(g), 16)
    payload = np.random.default_rng(2).normal(size=(60, 6)).astype(np.float32)
    jp, tp = jnp.asarray(payload), torch.from_numpy(payload)
    want = np.asarray(jex.push_attn(
        jp, lambda s, d: s[:, :2] * d[:, :2],
        lambda s, d: jnp.stack([s[:, 2:4], s[:, 4:6] + d[:, 4:6]], 1), 4))
    got = tex.push_attn(
        tp, lambda s, d: s[:, :2] * d[:, :2],
        lambda s, d: torch.stack([s[:, 2:4], s[:, 4:6] + d[:, 4:6]], 1), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tex.gather_src(tp).numpy(),
                                  np.asarray(jex.gather_src(jp)))
    for a, b in zip(tex.dst_index(), jex.dst_index()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tex.edge_geometry(), jex.edge_geometry()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_rotation_invariance(graph):
    """Twin of the reference's ``test_rotation_invariance`` for EGNN: a
    rotation of the positions leaves the logits unchanged."""
    _, tc, _, _ = _models("smoke")
    tp = td.init_model(tc, 1, 8, device="cpu")
    tg = _to_port(graph)
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.from_numpy(q.astype(np.float32))
    l1 = td.node_logits_local(tc, tp, tg)
    l2 = td.node_logits_local(tc, tp, tg._replace(
        positions=tg.positions @ rot.T))
    rel = float((l1 - l2).abs().max() / (l1.abs().max() + 1e-9))
    assert rel < 1e-4, rel


def test_unported_parts_raise(graph):
    """Named for what it checked before the ring was ported: a mesh that
    is not a ``Mesh``, and a FlatGraph over a mesh, are refused (the ring
    takes a RingGraph); every GNN model of the reference runs, and an
    unknown one is named."""
    cfg = get_config("egnn")
    tg = _to_port(graph)
    params = td.init_model(cfg, 0, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown GNN model"):
        td.init_model(cfg.replace(model="gat"), 0, 8, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        td.full_graph_loss(cfg, params, tg, mesh=object())
    with pytest.raises(TypeError, match="RingGraph"):
        td.full_graph_loss(cfg, params, tg, mesh=Mesh(["cpu"] * 2, ("data",)))
    for model in ("dimenet", "nequip", "equiformer_v2"):
        assert td.init_model(smoke_config("egnn").replace(model=model), 0, 8,
                             device="cpu")["head"].shape == (16, 16)


def test_entry_points_default_to_the_card():
    """No device given means CUDA: each raises on a host without one. The
    optimizer state follows the params' device."""
    from repro_torch.convert import adamw_state_from_jax
    from repro_torch.train.optimizer import init_adamw
    cfg = smoke_config("egnn")
    zeros = {"enc": np.zeros((2, 2), np.float32)}
    calls = (lambda: td.make_flat_graph(10, 20, 4),
             lambda: td.make_molecule_batch(2, 5, 8),
             lambda: td.init_model(cfg, 0, 4),
             lambda: gnn_params_from_jax(zeros),
             lambda: adamw_state_from_jax((np.int32(0), zeros, zeros)))
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    state = init_adamw(td.init_model(cfg, 0, 4, device="cpu"))
    assert {t.device.type for t in (state.step, state.mu["enc"],
                                    state.nu["head"])} == {"cpu"}
    assert state.mu["enc"].dtype == torch.float32


def test_launch_counter_stays_still_on_the_cpu(graph):
    before = ops.segment_sum_csr.launches
    _, tc, _, tp = _models("smoke")
    td.node_logits_local(tc, tp, _to_port(graph))
    assert ops.segment_sum_csr.launches == before
