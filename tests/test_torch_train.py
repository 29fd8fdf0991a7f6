"""The port's EGNN training slice against the JAX package's, on the CPU.

Both sides get the same inputs, made from a numpy seed, and the same
weights (the reference's ``init_model``, carried over by
``convert.gnn_params_from_jax``). On the CPU the port's aggregation and its
transposes run the segment-sum kernel's plain version; the reference
differentiates ``jax.ops.segment_sum``.

- Gradients of the segment primitives and of ``LocalExec.push`` /
  ``push_attn`` against ``jax.vjp`` of the reference's, and bitwise equal
  across chunk budgets (the message blocks cut small, so a layer has
  several, and chunks of one edge, several edges and the whole graph).
- AdamW, its schedules and the tree helpers against the reference's.
- One ``make_train_step`` step for each layout (full_graph, molecule,
  minibatch), from the start and from a reference state at step 3.
- The neighbour sampler's arrays equal the reference's exactly; the
  trainer's restart is bitwise; twins of the reference's own GNN and fault
  tests.

Tolerance of new params, losses, gradients and metrics: max |Δ| ≤ 1e-5 ·
max(1, max |want|), as ``test_torch_gnn.py`` holds the forward: fp32
matmuls and sums in another order over 2-4 layers and their backward.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.common import tree as j_tree
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models.gnn import common as j_common
from repro.models.gnn import driver as jd
from repro.runtime import fault as j_fault
from repro.sparse import sampler as j_sampler
from repro.sparse import segment as j_seg
from repro.train import optimizer as j_opt
from repro_torch.common import tree as t_tree
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import adamw_state_from_jax, gnn_params_from_jax
from repro_torch.kernels.segment_reduce import ops
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn import driver as td
from repro_torch.models.gnn.common import FlatGraph, LocalExec
from repro_torch.runtime.fault import (HeartbeatMonitor, RetryPolicy,
                                       plan_remesh)
from repro_torch.sparse import segment as t_seg
from repro_torch.sparse.sampler import NeighborSampler, sizes_for_fanout
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig

_CFGS = {"smoke": (j_smoke_config, smoke_config),
         "full": (j_get_config, get_config)}


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


def _models(which: str, d_feat: int = 8, n_out: int = jd.N_CLASSES, seed=0):
    j_cfg_fn, t_cfg_fn = _CFGS[which]
    jc, tc = j_cfg_fn("egnn"), t_cfg_fn("egnn")
    params, _ = jd.init_model(jc, jax.random.PRNGKey(seed), d_feat, n_out)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, tp


def _graph():
    """The 60-node graph with every 4th edge masked and every 9th
    destination out of range."""
    g = jd.make_flat_graph(60, 200, 8, seed=0)
    em = np.ones(200, bool)
    em[::4] = False
    dst = np.array(g.edge_dst)
    dst[1::9] = 75
    return g._replace(edge_mask=jnp.asarray(em), edge_dst=jnp.asarray(dst))


def _same_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(t_tree.leaves(a), t_tree.leaves(b)))


# ------------------------------------------------------------------ gradients
@pytest.mark.parametrize("trail", [(), (3,)])
@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean"])
def test_segment_grad_matches_jax(fn, trail):
    """Ids < 0 and >= n drop (gradient 0), segment 5 is empty."""
    rng = np.random.default_rng(len(trail))
    e, n = 300, 40
    ids = rng.integers(-3, n + 3, e).astype(np.int32)
    ids[ids == 5] = 6
    data = rng.normal(size=(e,) + trail).astype(np.float32)
    cot = rng.normal(size=(n,) + trail).astype(np.float32)
    want_out, vjp = jax.vjp(
        lambda d: getattr(j_seg, fn)(d, jnp.asarray(ids), n),
        jnp.asarray(data))
    (want,) = vjp(jnp.asarray(cot))
    x = _port(data).requires_grad_(True)
    out = getattr(t_seg, fn)(x, _port(ids), n)
    (got,) = torch.autograd.grad(out, x, _port(cot))
    _close(out, want_out)
    _close(got, want)
    assert not got.numpy()[(ids < 0) | (ids >= n)].any()


@pytest.mark.parametrize("with_perm", [False, True])
def test_segment_sum_csr_grad_is_its_transpose(with_perm):
    """Positions before ``rowptr[0]`` and past ``rowptr[n]`` feed no segment,
    so their messages get 0; ``out=`` is refused under grad."""
    rng = np.random.default_rng(3)
    e, d = 50, 4
    rowptr = torch.tensor([3, 3, 10, 20, 41], dtype=torch.int32)
    perm = (torch.from_numpy(rng.permutation(e).astype(np.int32))
            if with_perm else None)
    x = _port(rng.normal(size=(e, d)).astype(np.float32)).requires_grad_(True)
    cot = _port(rng.normal(size=(4, d)).astype(np.float32))
    out = ops.segment_sum_csr(x, rowptr, perm)
    (got,) = torch.autograd.grad(out, x, cot)
    a = torch.zeros((4, e))
    for i in range(4):
        for j in range(int(rowptr[i]), int(rowptr[i + 1])):
            a[i, int(perm[j]) if with_perm else j] = 1.0
    torch.testing.assert_close(out.detach(), a @ x.detach(), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, a.T @ cot)      # one segment per message: exact
    with pytest.raises(ValueError, match="out="):
        ops.segment_sum_csr(x, rowptr, perm, out=torch.empty((4, d)))


def _push_case(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(60, 5)).astype(np.float32),
            rng.normal(size=(10, 7)).astype(np.float32),
            rng.normal(size=(60, 7)).astype(np.float32))


def _port_push_grads(tg, budget, payload, w, cot):
    p = _port(payload).requires_grad_(True)
    wt = _port(w).requires_grad_(True)
    ex = LocalExec(tg, budget)
    out = ex.push(p, lambda s, d: torch.tanh(torch.cat([s, d * s], -1) @ wt),
                  7)
    return ex, out, torch.autograd.grad(out, (p, wt), _port(cot))


@pytest.mark.parametrize("budget", [1, 7, 10 ** 9])
def test_push_grads_match_reference(budget, monkeypatch):
    """Masked edges and out-of-range destinations, blocks of 16 edges."""
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 16)
    g = _graph()
    payload, w, cot = _push_case()

    def j_out(p, wj):
        return j_common.LocalExec(g).push(
            p, lambda s, d: jnp.tanh(jnp.concatenate([s, d * s], -1) @ wj), 7)

    want, vjp = jax.vjp(j_out, jnp.asarray(payload), jnp.asarray(w))
    want_p, want_w = vjp(jnp.asarray(cot))
    ex, out, (gp, gw) = _port_push_grads(_port_graph(g), budget, payload, w,
                                         cot)
    assert ex.block == 16 and -(-ex.n_edges // 16) > 5
    _close(out, want)
    _close(gp, want_p)
    _close(gw, want_w)


def test_push_grads_are_bitwise_independent_of_chunk_size(monkeypatch):
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 16)
    tg = _port_graph(_graph())
    case = _push_case(2)
    runs = [_port_push_grads(tg, b, *case) for b in (1, 2, 7, 33, 10 ** 9)]
    assert len({len(ex.chunks) for ex, _, _ in runs}) == 5
    for ex, out, grads in runs[1:]:
        assert torch.equal(out, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))
    # the forward under grad has the bits of the no-grad forward
    with torch.no_grad():
        plain = LocalExec(tg, 7).push(
            _port(case[0]), lambda s, d: torch.tanh(
                torch.cat([s, d * s], -1) @ _port(case[1])), 7)
    assert torch.equal(plain, runs[0][1])


def test_gather_transpose_equals_index_add():
    """``_GatherRows``' backward (the in-place segment sum over the
    compacted CSR of the rows it read, into its sink's buffer) against
    ``index_add_`` of the same cotangents, and the same bits twice."""
    rng = np.random.default_rng(4)
    table = _port(rng.normal(size=(30, 6)).astype(np.float32))
    idx = _port(rng.integers(0, 30, 200).astype(np.int32))
    cot = _port(rng.normal(size=(200, 6)).astype(np.float32))

    def grad():
        t = table.clone().requires_grad_(True)
        buf = t_common._GradBuffer(t)
        token = t_common._GradSink.apply(t, buf)
        rows = t_common._GatherRows.apply(
            token, idx, lambda g: buf.add(g, *t_common.csr_by_row(idx)))
        return torch.autograd.grad(rows, t, cot)[0]

    want = torch.zeros_like(table).index_add_(0, idx.long(), cot)
    got = grad()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, grad())


def test_push_attn_grads_match_reference(monkeypatch):
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 32)
    g = _graph()
    rng = np.random.default_rng(5)
    payload = rng.normal(size=(60, 6)).astype(np.float32)
    wl = rng.normal(size=(6, 2)).astype(np.float32)
    cot = rng.normal(size=(60, 4)).astype(np.float32)

    def j_out(p, wj):
        return j_common.LocalExec(g).push_attn(
            p, lambda s, d: (s * d) @ wj,
            lambda s, d: jnp.stack([s[:, 2:4], s[:, 4:6] + d[:, 4:6]], 1), 4)

    want, vjp = jax.vjp(j_out, jnp.asarray(payload), jnp.asarray(wl))
    want_p, want_w = vjp(jnp.asarray(cot))
    p = _port(payload).requires_grad_(True)
    wt = _port(wl).requires_grad_(True)
    out = LocalExec(_port_graph(g), 16).push_attn(
        p, lambda s, d: (s * d) @ wt,
        lambda s, d: torch.stack([s[:, 2:4], s[:, 4:6] + d[:, 4:6]], 1), 4)
    gp, gw = torch.autograd.grad(out, (p, wt), _port(cot))
    _close(out, want)
    _close(gp, want_p)
    _close(gw, want_w)


# ------------------------------------------------------------------ optimizer
def _opt_tree(rng, scale=1.0):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32) * scale,
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32) * scale},
                       {"b": rng.normal(size=(2,)).astype(np.float32) * scale}],
            "a": rng.normal(size=(7,)).astype(np.float32) * scale}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_matches_reference_over_five_steps(schedule, clip):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
               clip_norm=clip)
    jc, tc = j_opt.AdamWConfig(**cfg), t_opt.AdamWConfig(**cfg)
    rng = np.random.default_rng(6)
    params = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(_port, params)
    js, ts = j_opt.init_adamw(jp), t_opt.init_adamw(tp)
    for step in range(5):
        grads = _opt_tree(rng, scale=3.0 if step % 2 else 0.01)
        jp, js, jm = j_opt.adamw_update(jc, jax.tree.map(jnp.asarray, grads),
                                        js, jp)
        tp, ts, tm = t_opt.adamw_update(tc, jax.tree.map(_port, grads), ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        for mine, ref in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(t_tree.leaves(mine), jax.tree.leaves(ref)):
                assert a.dtype == torch.float32
                _close(a, b)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000,
              schedule=schedule)
    jc, tc = j_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    steps = np.array([0, 1, 50, 99, 100, 101, 2_500, 9_999, 10_000, 20_000],
                     np.int32)
    want = np.asarray(j_opt.schedule_lr(jc, jnp.asarray(steps)))
    got = t_opt.schedule_lr(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(7)
    tree = _opt_tree(rng)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = jax.tree.map(_port, tree)
    assert t_tree.count_params(tt) == j_tree.count_params(jt) == 26
    assert t_tree.tree_bytes(tt) == j_tree.tree_bytes(jt) == 104
    half = {"h": torch.zeros(3, dtype=torch.bfloat16), "f": tt["w"]}
    assert t_tree.tree_bytes(half) == 6 + 48
    _close(t_tree.global_norm(tt), j_tree.global_norm(jt))
    assert bool(t_tree.tree_finite(tt)) and bool(j_tree.tree_finite(jt))
    tt["layers"][1]["b"][0] = float("nan")
    assert not bool(t_tree.tree_finite(tt))
    assert [tuple(x.shape) for x in t_tree.leaves(tt)] == [
        tuple(x.shape) for x in jax.tree.leaves(jt)]
    state = t_opt.init_adamw(tt)
    assert [k for k in state._fields] == ["step", "mu", "nu"]
    assert len(t_tree.leaves(state)) == 1 + 2 * 4


# ---------------------------------------------------------------- train steps
def _minibatch(n_classes=jd.N_CLASSES, seed=0, b=8, fanouts=(3, 2)):
    rng = np.random.default_rng(seed)
    n, e = 200, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[dst < 20] = 20                 # nodes 0..19 have no in-neighbours
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    batch = j_sampler.NeighborSampler(n, src, dst, feats, labels,
                                      seed=seed).sample(
        np.arange(10, 10 + b), fanouts)
    assert not batch.edge_mask.all()
    safe = np.clip(batch.nodes, 0, n - 1)
    g = j_common.FlatGraph(
        feats=jnp.asarray(batch.feats),
        positions=jnp.asarray(pos[safe] * (batch.nodes >= 0)[..., None]),
        edge_src=jnp.asarray(batch.edge_src),
        edge_dst=jnp.asarray(batch.edge_dst),
        edge_mask=jnp.asarray(batch.edge_mask),
        node_mask=jnp.asarray(batch.nodes >= 0),
        labels=jnp.zeros(batch.nodes.shape, jnp.int32))
    return g, jnp.asarray(batch.labels)


def _batches(kind):
    """(reference batch, port batch, d_feat, n_out) of one layout."""
    if kind == "full_graph":
        g = _graph()
        return {"graph": g}, {"graph": _port_graph(g)}, 8, jd.N_CLASSES
    if kind == "molecule":
        jb, je = jd.make_molecule_batch(4, 10, 24, seed=0)
        nm = np.ones((4, 10), bool)
        nm[2, 7:] = False
        jb = jb._replace(node_mask=jnp.asarray(nm))
        return ({"graph": jb, "energy": je},
                {"graph": _port_graph(jb), "energy": _port(je)}, 4, 1)
    g, labels = _minibatch()
    return ({"graph": g, "labels": labels},
            {"graph": _port_graph(g), "labels": _port(labels)}, 6,
            jd.N_CLASSES)


def _check_step(jout, tout):
    (jp, js, jm), (tp, ts, tm) = jout, tout
    for a, b in zip(t_tree.leaves(tp), jax.tree.leaves(jp)):
        _close(a, b)
    for a, b in zip(t_tree.leaves(ts.mu), jax.tree.leaves(js.mu)):
        _close(a, b)
    assert int(ts.step) == int(js.step)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("kind", ["full_graph", "molecule", "minibatch"])
def test_train_step_matches_reference(kind, which):
    jb, tb, d_feat, n_out = _batches(kind)
    jc, tc, params, tp = _models(which, d_feat, n_out)
    jout = jax.jit(jd.make_train_step(jc, kind))(params,
                                                 j_opt.init_adamw(params), jb)
    tout = td.make_train_step(tc, kind)(tp, t_opt.init_adamw(tp), tb)
    _check_step(jout, tout)
    # the step returns new trees: its inputs are as they were
    assert _same_trees(tp, gnn_params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"))


def test_step_from_a_reference_state_at_step_3():
    jb, tb, d_feat, n_out = _batches("full_graph")
    jc, tc, params, _ = _models("full", d_feat, n_out)
    opt = j_opt.AdamWConfig(lr=1e-2, warmup_steps=2)
    jstep = jax.jit(jd.make_train_step(jc, "full_graph", opt_cfg=opt))
    jstate = j_opt.init_adamw(params)
    for _ in range(3):
        params, jstate, _ = jstep(params, jstate, jb)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert isinstance(ts, t_opt.AdamWState) and int(ts.step) == 3
    assert ts.step.dtype == torch.int32
    _check_step(jstep(params, jstate, jb),
                td.make_train_step(tc, "full_graph", opt_cfg=opt)(tp, ts, tb))


def test_train_step_is_bitwise_independent_of_chunk_size(monkeypatch):
    """A full-width EGNN step: blocks of 64 edges, chunk budgets from one
    edge to the whole graph give the same new params and metrics."""
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 64)
    _, tc, _, tp = _models("full")
    g = _port_graph(_graph())
    step = td.make_train_step(tc, "full_graph")
    outs = [step(tp, t_opt.init_adamw(tp), {"graph": g,
                                           "exec": LocalExec(g, b)})
            for b in (1, 10, 10 ** 9)]
    for p, s, m in outs[1:]:
        assert _same_trees(p, outs[0][0]) and _same_trees(s, outs[0][1])
        assert all(torch.equal(m[k], outs[0][2][k]) for k in m)


def test_unported_training_parts_raise():
    cfg = smoke_config("egnn")
    with pytest.raises(NotImplementedError, match="item 15"):
        td.make_train_step(cfg, "full_graph", mesh=object())
    with pytest.raises(ValueError):
        td.train_loss(cfg, "nope", {}, {})


# ------------------------------------------------------------------- sampler
@pytest.mark.parametrize("fanouts", [(3, 2), (15, 10), (4,)])
def test_sampler_arrays_equal_the_reference(fanouts):
    rng = np.random.default_rng(8)
    n, e = 300, 3000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[dst < 30] = 30                 # nodes 0..29 have no in-neighbours
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    labels = rng.integers(0, 7, n)
    targets = np.array([0, 5, 31, 299, 100, 31])
    for seed in (0, 9):
        want = j_sampler.NeighborSampler(n, src, dst, feats, labels,
                                         seed).sample(targets, fanouts)
        got = NeighborSampler(n, src, dst, feats, labels, seed).sample(
            targets, fanouts)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert sizes_for_fanout(fanouts) == j_sampler.sizes_for_fanout(fanouts)


def test_neighbor_sampler_tree_shapes():
    """Twin of ``tests/test_gnn.py::test_neighbor_sampler_tree_shapes``."""
    rng = np.random.default_rng(0)
    n, e = 200, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    s = NeighborSampler(n, src, dst, feats, labels)
    batch = s.sample(np.arange(8), (3, 2))
    n_sub, n_edge = sizes_for_fanout((3, 2))
    assert batch.nodes.shape == (8, n_sub)
    assert batch.edge_src.shape == (8, n_edge)
    # every masked edge's endpoints are valid local indices
    assert batch.edge_src.max() < n_sub and batch.edge_dst.max() < n_sub
    # roots are the targets
    np.testing.assert_array_equal(batch.nodes[:, 0], np.arange(8))


def test_minibatch_loss_runs():
    """Twin of ``tests/test_gnn.py::test_minibatch_loss_runs``."""
    rng = np.random.default_rng(0)
    n, e = 200, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, td.N_CLASSES, n)
    s = NeighborSampler(n, src, dst, feats, labels)
    batch = s.sample(np.arange(8), (3, 2))
    cfg = smoke_config("egnn")
    params = td.init_model(cfg, 0, 6, device="cpu")
    b = batch.nodes.shape[0]
    n_sub = batch.nodes.shape[1]
    pos = rng.normal(size=(b, n_sub, 3)).astype(np.float32)
    g = FlatGraph(feats=_port(batch.feats), positions=_port(pos),
                  edge_src=_port(batch.edge_src),
                  edge_dst=_port(batch.edge_dst),
                  edge_mask=_port(batch.edge_mask),
                  node_mask=_port(batch.nodes >= 0),
                  labels=torch.zeros((b, n_sub), dtype=torch.int32))
    sums = td.minibatch_loss(cfg, params, g, _port(batch.labels))
    assert np.isfinite(float(sums["loss_sum"]))


def test_train_step_runs():
    """Twin of ``tests/test_gnn.py::test_train_step_runs[egnn]``."""
    cfg = smoke_config("egnn")
    graph = td.make_flat_graph(60, 200, 8, seed=0, device="cpu")
    params = td.init_model(cfg, 0, 8, device="cpu")
    step = td.make_train_step(cfg, "full_graph")
    opt = t_opt.init_adamw(params)
    p, o, m = step(params, opt, {"graph": graph, "triplets": None})
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------------------------------- trainer
class _VaryingStream:
    """A deterministic stream whose batch changes with the step."""

    def batch_at(self, step):
        return {"graph": td.make_flat_graph(40, 120, 8, seed=100 + step,
                                            device="cpu")}


def _trainer(tmp):
    cfg = smoke_config("egnn")
    params = td.init_model(cfg, 3, 8, device="cpu")
    tcfg = TrainerConfig(total_steps=5, checkpoint_every=2,
                         checkpoint_dir=str(tmp), log_every=1)
    step = td.make_train_step(cfg, "full_graph",
                              opt_cfg=t_opt.AdamWConfig(lr=1e-2,
                                                        warmup_steps=1))
    return Trainer(tcfg, step, _VaryingStream(), params,
                   t_opt.init_adamw(params))


def test_trainer_restart_is_bitwise(tmp_path):
    """A failure at step 3 restores the step-2 checkpoint and re-runs steps
    2-4 on their own batches: the final state equals an uninterrupted
    run's bit for bit."""
    plain = _trainer(tmp_path / "plain")
    out = plain.run()
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5]
    assert out["stragglers"].slow_workers == []
    failed = {"n": 0}

    def inject(step):
        if step == 3 and not failed["n"]:
            failed["n"] += 1
            raise RuntimeError("injected step failure")

    faulty = _trainer(tmp_path / "faulty")
    faulty.run(fail_injector=inject)
    assert failed["n"] == 1 and faulty.step == plain.step == 5
    assert _same_trees(faulty.params, plain.params)
    assert _same_trees(faulty.opt_state, plain.opt_state)
    # a new trainer on the directory resumes from the last checkpoint
    again = _trainer(tmp_path / "plain")
    assert again.try_restore() and again.step == 5
    assert _same_trees(again.params, plain.params)


# ------------------------------------------------------------ fault (twins)
class TestFault:
    """Twins of ``tests/test_infra.py::TestFault``, and the port's copy
    against the reference's on the same timings."""

    def test_straggler_detection(self):
        m = HeartbeatMonitor(4, ratio=1.5)
        for _ in range(8):
            for w in range(4):
                m.record(w, 1.0 if w != 2 else 3.0)
        rep = m.stragglers()
        assert rep.slow_workers == [2]

    def test_remesh_plan_keeps_global_batch(self):
        plan = plan_remesh(16, failed_workers=3, keep_global_batch=True)
        assert plan.new_data <= 13 and 16 % plan.new_data == 0
        assert plan.grad_accum_factor * plan.new_data == 16

    def test_retry_restores(self):
        calls = {"n": 0, "restores": 0}

        def step():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("boom")
            return "ok"

        def restore():
            calls["restores"] += 1

        out = RetryPolicy(max_retries=3, backoff_s=0.0).run(step, restore)
        assert out == "ok" and calls["restores"] == 2

    def test_policies_equal_the_reference(self):
        rng = np.random.default_rng(9)
        times = rng.gamma(4.0, 0.25, size=(16, 6))
        times[:, 5] *= 2.2
        mine, ref = HeartbeatMonitor(6), j_fault.HeartbeatMonitor(6)
        for row in times:
            for w, t in enumerate(row):
                mine.record(w, float(t), now=1.0)
                ref.record(w, float(t), now=1.0)
        assert dataclasses.asdict(mine.stragglers()) == dataclasses.asdict(
            ref.stragglers())
        assert mine.dead_workers(5.0, now=10.0) == ref.dead_workers(
            5.0, now=10.0)
        for size, failed in ((16, 3), (8, 1), (6, 5), (12, 0)):
            for keep in (True, False):
                assert dataclasses.asdict(plan_remesh(size, failed, keep)) \
                    == dataclasses.asdict(j_fault.plan_remesh(size, failed,
                                                              keep))
