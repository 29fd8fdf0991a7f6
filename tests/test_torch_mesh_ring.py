"""The port's GNN ring (``models/gnn/common.py``: ``to_ring``, ``RingExec``,
``run_flat(mesh=)``; the driver's ``full_graph_loss(mesh=)`` and
``make_train_step(mesh=)``) and DimeNet's line-graph ring
(``build_triplet_ring``, ``ring_loss``) against the JAX package's own
``shard_map`` programs, on the CPU.

The reference runs once for the module, in a subprocess with four host
CPU devices (``tests/torch_mesh_ref.py ring``), at S = 2 and 4 data
shards and on a (2, 2) grid over ("data", "model"); the port runs the
same meshes as ``Mesh(["cpu"] * S, ...)`` on the reference's graph and
parameters (``convert.gnn_params_from_jax``, ``ring_graph_from_jax``).

- Bit for bit: ``to_ring``'s arrays (with and without ``e_cap``) and
  ``build_triplet_ring``'s.
- Within 1e-5 relative (fp32 sums in another order): the ring loss sums of
  EGNN, NequIP and Equiformer-v2 at smoke width, and DimeNet's; each ring
  also against its own package's local path, on both sides.
- Within 1e-4 relative: the ring's gradients, and one ring train step,
  against the reference's.
- The reference's gaps (ROADMAP.md Queue 3), pinned: its ring needs a
  "model" axis; its DimeNet ``full_graph_loss(mesh=)`` raises; its
  triplet ring keeps other in-edges than its local triplets when the cap
  binds.
- The layout, as ``shard_map``'s: over S = 4 each shard's body runs in a
  thread of its own on its 16 node rows, and no operator inside a body
  returns a tensor with the graph's 64 node rows (a dispatch hook entered
  in each shard's thread); ``RingShard.dst_index`` gives local rows, the
  reference's arrays.
"""
import pytest

pytest.importorskip("torch")

import os
import subprocess
import sys
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import smoke_config
from repro_torch.convert import gnn_params_from_jax, ring_graph_from_jax
from repro_torch.models.gnn import common, dimenet
from repro_torch.models.gnn import driver as td
from repro_torch.sharding import Mesh
from repro_torch.sharding import collectives as col
from repro_torch.train.optimizer import init_adamw

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {"s2": (2, 1), "s4": (4, 1), "g22": (2, 2)}
ARCHS = ("egnn", "nequip", "equiformer-v2")
RTOL = 1e-5


def run_reference(which: str, tmp_path) -> dict:
    """The reference's outputs from ``torch_mesh_ref.py`` (one process)."""
    out = str(tmp_path / f"{which}.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, os.path.join(HERE, "torch_mesh_ref.py"),
                        which, out], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def subtree(ref: dict, prefix: str):
    """The tree stored under ``prefix`` (dicts; all-digit keys as lists)."""
    root = {}
    for k, v in ref.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = root, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    return lists(root)


def mesh(name: str) -> Mesh:
    shape = MESHES[name]
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                ("data", "model"))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("ring", tmp_path_factory.mktemp("mesh_ring"))


@pytest.fixture(scope="module")
def graph(ref):
    g = subtree(ref, "graph")
    return common.FlatGraph(*(torch.from_numpy(np.asarray(g[k]))
                              for k in common.FlatGraph._fields))


@pytest.mark.parametrize("s", [2, 4])
def test_to_ring_arrays_bitwise(ref, graph, s):
    """``to_ring`` gives the reference's arrays, with the largest group as
    the capacity and at a capacity that cuts groups (20)."""
    for tag, kw in (("", {}), ("_cap", {"e_cap": 20})):
        want = ring_graph_from_jax(subtree(ref, f"ring{s}{tag}"), "cpu")
        got = common.to_ring(graph, s, **kw)
        for f in common.RingGraph._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (tag, f)


@pytest.mark.parametrize("cap", [8, 100])
@pytest.mark.parametrize("s", [2, 4])
def test_build_triplet_ring_bitwise(ref, graph, s, cap):
    _, ts, td_, tm = dimenet.build_triplet_ring(graph, s, cap)
    want = subtree(ref, f"tri{s}_{cap}")
    for got, w in zip((ts, td_, tm), want):
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


def _loss_sums(cfg, params, graph, name):
    s = MESHES[name][0]
    return td.full_graph_loss(cfg, params, common.to_ring(graph, s),
                              mesh(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_loss_sums_match_reference(ref, graph, arch):
    """The ring's loss sums at S = 2, 4 and (2, 2) against the reference's
    ring, and against the port's local path (and the reference's ring
    against its own local path)."""
    cfg = smoke_config(arch)
    params = gnn_params_from_jax(subtree(ref, f"{arch}/params"), "cpu")
    local = td.full_graph_loss(cfg, params, graph)
    jl = subtree(ref, f"{arch}/local")
    assert rel(local["loss_sum"], jl["loss_sum"]) < RTOL
    for name in MESHES:
        got = _loss_sums(cfg, params, graph, name)
        want = subtree(ref, f"{arch}/{name}")
        for k in ("loss_sum", "count", "correct"):
            assert rel(got[k], want[k]) < RTOL, (name, k)
        assert rel(got["loss_sum"], local["loss_sum"]) < RTOL
        assert rel(want["loss_sum"], jl["loss_sum"]) < RTOL


def paired(got, want):
    """(got leaf, want leaf) pairs, matched by their keys in the trees."""
    if isinstance(got, dict):
        return [p for k in got for p in paired(got[k], want[k])]
    if isinstance(got, (list, tuple)):
        return [p for a, b in zip(got, want) for p in paired(a, b)]
    return [(got, want)]


def _grads(cfg, params, ring, m):
    """The gradient tree of the ring's (or the local) training loss."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    loss, _ = td.train_loss(cfg, "full_graph", tree, {"graph": ring}, m)
    got = iter(torch.autograd.grad(loss, live))
    return tree_map(lambda _: next(got), params)


@pytest.mark.parametrize("name", ["s4", "g22"])
def test_ring_gradients_and_step_match_reference(ref, graph, name):
    """EGNN's gradients through the ring (``jax.grad`` of the reference's
    ring loss), and one ``make_train_step(mesh=)`` (new params, metrics),
    within 1e-4 of the reference's; the gradients also within 1e-4 of the
    port's local ones."""
    cfg = smoke_config("egnn")
    params = gnn_params_from_jax(subtree(ref, "egnn/params"), "cpu")
    ring = common.to_ring(graph, MESHES[name][0])
    got = _grads(cfg, params, ring, mesh(name))
    local = _grads(cfg, params, graph, None)
    want = subtree(ref, f"egnn/grad/{name}")
    for (g, w), (_, l) in zip(paired(got, want), paired(got, local)):
        assert rel(g, w) < 1e-4
        assert rel(g, l) < 1e-4
    new, _, metrics = td.make_train_step(cfg, "full_graph", mesh(name))(
        params, init_adamw(params), {"graph": ring})
    want_new = gnn_params_from_jax(subtree(ref, f"egnn/step/{name}/params"),
                                   "cpu")
    for a, b in paired(new, want_new):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))
    wm = subtree(ref, f"egnn/step/{name}/metrics")
    for k in ("loss", "grad_norm", "loss_sum"):
        assert rel(metrics[k], wm[k]) < 1e-4, k


@pytest.mark.parametrize("cap", [8, 100])
def test_dimenet_ring_matches_reference(ref, graph, cap):
    """DimeNet's ``ring_loss`` at S = 2 and (2, 2) against the reference's,
    reached through ``full_graph_loss(mesh=, triplets=)``. At a triplet cap
    that does not bind (100) each ring matches its own package's local
    loss; at 8 both rings keep the same triplets, other ones than the
    local path (ROADMAP.md Queue 3)."""
    cfg = smoke_config("dimenet")
    params = gnn_params_from_jax(subtree(ref, "dimenet/params"), "cpu")
    trip = dimenet.build_triplets(graph.edge_src, graph.edge_dst,
                                  graph.edge_mask, cap, device="cpu")
    local = td.full_graph_loss(cfg, params, graph, triplets=trip)
    jl = subtree(ref, f"dimenet/local_{cap}")["loss_sum"]
    assert rel(local["loss_sum"], jl) < RTOL
    for name in ("s2", "g22"):
        ring, *tri = dimenet.build_triplet_ring(graph, MESHES[name][0], cap)
        got = td.full_graph_loss(cfg, params, ring, mesh(name), tuple(tri))
        want = subtree(ref, f"dimenet/{name}_{cap}")["loss_sum"]
        assert rel(got["loss_sum"], want) < RTOL
        if cap == 100:
            assert rel(got["loss_sum"], local["loss_sum"]) < RTOL
            assert rel(want, jl) < RTOL
        else:
            assert rel(want, jl) > 1e-3          # the reference's own gap


def test_reference_gaps_and_the_ports_intent(ref, graph):
    """The reference's ring raises on a mesh without a "model" axis, and
    its DimeNet ``full_graph_loss(mesh=)`` raises (its ``node_logits``
    reads ``ex.g``, which ``RingExec`` lacks). The port runs both: the
    first without a model split, the second as ``ring_loss`` (without
    triplets, no triplet interaction, as the local path without them)."""
    assert str(ref["raises/data_only_ring"]).startswith("ValueError")
    assert "no attribute 'g'" in str(ref["raises/dimenet_full_graph_loss"])
    cfg = smoke_config("egnn")
    params = gnn_params_from_jax(subtree(ref, "egnn/params"), "cpu")
    data_only = Mesh(["cpu"] * 2, ("data",))
    got = td.full_graph_loss(cfg, params, common.to_ring(graph, 2), data_only)
    want = subtree(ref, "egnn/s2")["loss_sum"]
    assert rel(got["loss_sum"], want) < RTOL
    dcfg = smoke_config("dimenet")
    dparams = gnn_params_from_jax(subtree(ref, "dimenet/params"), "cpu")
    ring = common.to_ring(graph, 2)
    no_trip = td.full_graph_loss(dcfg, dparams, ring, mesh("s2"))
    local = td.full_graph_loss(dcfg, dparams, graph)
    assert rel(no_trip["loss_sum"], local["loss_sum"]) < RTOL


def test_one_shard_runs_the_ring_and_repeats_bitwise(graph):
    """S = 1 runs through ``RingExec`` (not ``LocalExec``); two ring runs,
    and two chunk budgets, give the same bits; a ring built for other
    shards than the mesh's is refused."""
    cfg = smoke_config("egnn")
    params = td.init_model(cfg, 0, 8, device="cpu")
    one = Mesh(["cpu"], ("data",))
    ring = common.to_ring(graph, 1)
    ex = common.RingExec.of(ring, one)
    assert isinstance(ex, common.RingExec) and ex.chunk_count() == 1
    a = td.full_graph_loss(cfg, params, ring, one, ex=ex)
    ring4 = common.to_ring(graph, 4)
    m4 = Mesh(["cpu"] * 4, ("data",))
    b = td.full_graph_loss(cfg, params, ring4, m4)
    c = td.full_graph_loss(cfg, params, ring4, m4)
    d = td.full_graph_loss(cfg, params, ring4, m4,
                           ex=common.RingExec.of(ring4, m4, chunk_edges=7))
    assert all(torch.equal(b[k], c[k]) and torch.equal(b[k], d[k])
               for k in b)
    assert rel(a["loss_sum"], b["loss_sum"]) < RTOL
    with pytest.raises(ValueError, match="data shards"):
        td.full_graph_loss(cfg, params, ring4, Mesh(["cpu"] * 2, ("data",)))
    with pytest.raises(ValueError, match="minibatch"):
        td.make_train_step(cfg, "minibatch", m4)


def test_pad_to_shards_keeps_the_loss(graph):
    """Masked nodes without edges, appended up to a multiple of the
    shards, change no loss sum (ogbn-products' 2,449,029 nodes are odd)."""
    cfg = smoke_config("egnn")
    params = td.init_model(cfg, 0, 8, device="cpu")
    g = graph._replace(feats=graph.feats[:-1], positions=graph.positions[:-1],
                       node_mask=graph.node_mask[:-1],
                       labels=graph.labels[:-1],
                       edge_mask=graph.edge_mask & (graph.edge_src < 63)
                       & (graph.edge_dst < 63))
    padded = common.pad_to_shards(g, 4)
    assert padded.n_nodes == 64 and not bool(padded.node_mask[-1])
    want = td.full_graph_loss(cfg, params, g)
    got = td.full_graph_loss(cfg, params, common.to_ring(padded, 4),
                             Mesh(["cpu"] * 4, ("data",)))
    for k in want:
        assert rel(got[k], want[k]) < RTOL


class _Rows(TorchDispatchMode):
    """Records (operator, shape, thread) of every tensor an operator
    returns in the thread that entered it."""

    def __init__(self, seen: list):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.append((func.overloadpacket.__name__,
                                  tuple(t.shape), threading.get_ident()))
        return out


@pytest.mark.parametrize("arch", ["egnn", "equiformer-v2", "dimenet"])
def test_each_shard_holds_only_its_own_node_rows(ref, graph, arch,
                                                 monkeypatch):
    """Over S = 4 on the 64-node graph (n_loc 16; blocks of 16 edges, and
    edge caps and per-shard edge counts that are not 64), each shard's
    body runs in a thread of its own on its 16 node rows, and no tensor an
    operator returns inside it (EGNN's ``push``, Equiformer-v2's
    ``push_attn``, DimeNet's node and triplet rings) has the graph's 64
    node rows. The loss sums stay the ring's."""
    monkeypatch.setattr(common, "MSG_BLOCK_EDGES", 16)
    cfg = smoke_config(arch)
    params = gnn_params_from_jax(subtree(ref, f"{arch}/params"), "cpu")
    m4 = Mesh(["cpu"] * 4, ("data",))
    n, n_loc = graph.n_nodes, graph.n_nodes // 4
    ring, *tri = dimenet.build_triplet_ring(graph, 4, 100)
    _, rounds, cap = ring.esrc_local.shape
    per_shard = ring.edge_mask.sum((1, 2)).tolist()
    assert n == 64 and cap != n and rounds * cap != n
    assert n not in per_shard and n not in ring.edge_mask.sum(2).flatten()
    seen, threads = [], set()

    def node_rows(f, x, nm, lb):
        threads.add(threading.get_ident())
        assert all(t.shape[0] == n_loc for t in (f, x, nm, lb))

    if arch == "dimenet":
        assert n not in tri[2].sum((1, 2)).tolist()
        assert n not in tri[2].sum(2).flatten() and tri[0].shape[2] != n
        inner = dimenet.node_logits_ring

        def logits_ring(cfg_, p, f, x, nm, ex_nodes, ex_tri):
            node_rows(f, x, nm, nm)
            with _Rows(seen):
                return inner(cfg_, p, f, x, nm, ex_nodes, ex_tri)

        monkeypatch.setattr(dimenet, "node_logits_ring", logits_ring)
        got = td.full_graph_loss(cfg, params, ring, m4, tuple(tri))
        want = subtree(ref, "dimenet/s2_100")["loss_sum"]
    else:
        mod = td._module(cfg)

        def apply_local(p, f, x, nm, lb, ex):
            node_rows(f, x, nm, lb)
            with _Rows(seen):
                return td._ce_sums(mod.node_logits(cfg, p, f, x, nm, ex),
                                   lb, nm)

        got = common.run_flat(apply_local, common.to_ring(graph, 4), params,
                              m4)
        want = subtree(ref, f"{arch}/s4")["loss_sum"]
    assert rel(got["loss_sum"], want) < RTOL
    assert len(threads) == 4 and threading.get_ident() not in threads
    assert {tid for *_, tid in seen} == threads
    whole = [(op, shape) for op, shape, _ in seen if shape and shape[0] == n]
    assert len(seen) > 100 and not whole, whole[:5]


def test_dst_index_gives_local_rows(ref, graph):
    """``RingShard.dst_index`` of each shard's engine gives its local
    destination rows and mask in slot order: the reference's ``edst_local``
    and ``edge_mask`` of that shard (its ``dst_index``); with a "model"
    split, the shard's piece of each round. The ring over the whole mesh
    (``RingExec``) has no shard's methods."""
    want = ring_graph_from_jax(subtree(ref, "ring4"), "cpu")
    m4 = Mesh(["cpu"] * 4, ("data",))
    ex = common.RingExec.of(common.to_ring(graph, 4), m4)
    assert all(isinstance(e, common.RingShard)
               for e in col.spmd(m4, ex.shard))
    got = col.spmd(m4, lambda ctx: ex.shard(ctx).dst_index())
    for d, (idx, mask) in enumerate(got):
        assert idx.dtype == torch.int64 and int(idx.max()) < 16
        assert torch.equal(idx, want.edst_local[d].reshape(-1).long())
        assert torch.equal(mask, want.edge_mask[d].reshape(-1))
    assert not any(hasattr(ex, f) for f in ("push", "push_attn",
                                              "gather_src", "dst_index"))
    g22 = mesh("g22")
    ring2 = common.to_ring(graph, 2)
    cap = ring2.esrc_local.shape[2]
    piece = -(-cap // 2)
    ex2 = common.RingExec.of(ring2, g22)
    for ctx_idx, (idx, mask) in zip(
            col.shards(g22), col.spmd(g22, lambda c: ex2.shard(c).dst_index())):
        d, m = ctx_idx.coords["data"], ctx_idx.coords["model"]
        sl = slice(m * piece, (m + 1) * piece)
        assert torch.equal(idx, ring2.edst_local[d][:, sl].reshape(-1).long())
        assert torch.equal(mask, ring2.edge_mask[d][:, sl].reshape(-1))


def test_shards_of_one_device_add_into_the_senders_buffer(graph,
                                                          monkeypatch):
    """Under grad, on a mesh whose shards share one device, a block that
    rotates in is the sender's token, and its gathers' transposes add into
    the sender's gradient buffer: a backward makes one buffer a shard and
    push, none for a rotated-in block, and its gradients repeat bit for
    bit. Forced to copy each rotated block (as a move between devices
    does), the ring makes a buffer for every block and round, and its
    gradients agree within 1e-6."""
    cfg = smoke_config("egnn")
    params = td.init_model(cfg, 0, 8, device="cpu")
    ring = common.to_ring(graph, 4)
    m4 = Mesh(["cpu"] * 4, ("data",))
    made, add = [0], common._GradBuffer.add

    def counted(self, *a, **k):
        made[0] += self.buf is None
        add(self, *a, **k)

    monkeypatch.setattr(common._GradBuffer, "add", counted)

    def grads():
        made[0] = 0
        got = _grads(cfg, params, ring, m4)
        return got, made[0]

    a, n_a = grads()
    b, _ = grads()
    assert n_a == cfg.n_layers * 4
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    rotate = col.ShardCtx.rotate
    monkeypatch.setattr(col.ShardCtx, "rotate",
                        lambda self, x, axes: rotate(self, x, axes).clone())
    c, n_c = grads()
    assert n_c == cfg.n_layers * 4 * 4
    for x, y in zip(leaves(a), leaves(c)):
        assert rel(x, y) < 1e-6

