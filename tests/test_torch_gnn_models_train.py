"""One AdamW step of the port's DimeNet, NequIP and Equiformer-v2 against
the JAX package's jitted ``make_train_step``, on the CPU, at
``smoke_config``, in the three layouts (DimeNet with its triplets in the
full-graph and molecule layouts: the molecule batch's (B, T) per graph
against the reference's ``vmap``), and a step's bits independent of the
chunk budget. The reference's steps are computed once per module.

Tolerance: new params, moments, loss and metrics within 1e-5 ·
max(1, max |want|) (fp32 sums in another order over two layers).
"""
import pytest

pytest.importorskip("torch")

import jax
import numpy as np
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.gnn import driver as jd
from repro.train import optimizer as j_opt
from repro_torch.common import tree as t_tree
from repro_torch.configs import smoke_config
from repro_torch.convert import gnn_params_from_jax
from repro_torch.models.gnn import common as t_common
from repro_torch.models.gnn import driver as td
from repro_torch.models.gnn.common import LocalExec
from repro_torch.train import optimizer as t_opt
from test_torch_gnn_models import (ARCHS, _batches, _close, _masked, _models,
                                   _port_graph, _trips)

KINDS = ["full_graph", "molecule", "minibatch"]


@pytest.fixture(scope="module")
def graph():
    return jd.make_flat_graph(60, 200, 8, seed=0)


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's jitted step per (arch, kind), computed once."""
    cache = {}

    def get(arch, kind):
        if (arch, kind) not in cache:
            jc = j_smoke_config(arch)
            jb, tb, d_feat, n_out = _batches(kind, jc)
            params, _ = jd.init_model(jc, jax.random.PRNGKey(0), d_feat, n_out)
            out = jax.jit(jd.make_train_step(jc, kind))(
                params, j_opt.init_adamw(params), jb)
            cache[(arch, kind)] = (params, tb, jax.tree.map(np.asarray, out))
        return cache[(arch, kind)]

    return get


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, kind, reference_steps):
    """One AdamW step (loss, metrics, new params and moments) against the
    reference's jitted ``make_train_step``; DimeNet takes its triplets in
    the full-graph and molecule layouts (the molecule batch's (B, T) per
    graph against the reference's ``vmap``), none in the minibatch."""
    params, tb, (jp, js, jm) = reference_steps(arch, kind)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tp2, ts, tm = td.make_train_step(smoke_config(arch), kind)(
        tp, t_opt.init_adamw(tp), tb)
    for a, b in zip(t_tree.leaves(tp2), jax.tree.leaves(jp)):
        _close(a, b)
    for a, b in zip(t_tree.leaves(ts.mu), jax.tree.leaves(js.mu)):
        _close(a, b)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_molecule_loss_matches_vmapped_reference(arch, reference_steps):
    """The forward loss sums of the port's disjoint-union batch (with its
    triplets offset by b·E, the padded ones dropped) against the sums the
    reference's step took, by ``vmap`` over graphs, at the same params."""
    params, tb, (_, _, jm) = reference_steps(arch, "molecule")
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    with torch.no_grad():
        got = td.molecule_loss(smoke_config(arch), tp, tb["graph"],
                               tb["energy"], tb["triplets"])
    _close(got["loss_sum"], jm["loss_sum"])
    assert float(got["count"]) == float(jm["count"]) == 4.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_is_bitwise_independent_of_chunk_budget(arch, graph,
                                                           monkeypatch):
    monkeypatch.setattr(t_common, "MSG_BLOCK_EDGES", 32)
    jc, tc, _, tp = _models(arch)
    g = _port_graph(_masked(graph))
    _, tt = _trips(jc, _masked(graph))
    step = td.make_train_step(tc, "full_graph")
    outs = [step(tp, t_opt.init_adamw(tp), {"graph": g, "triplets": tt,
                                           "exec": LocalExec(g, b)})
            for b in (1, 10 ** 9, 10 ** 9)]
    for p, s, m in outs[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(t_tree.leaves(p), t_tree.leaves(outs[0][0])))
        assert all(torch.equal(m[k], outs[0][2][k]) for k in m)


@pytest.mark.parametrize("arch", ["egnn"] + ARCHS)
def test_train_step_raises_on_a_leaf_cut_off_from_the_loss(arch, graph):
    """A leaf the loss does not reach raises; only DimeNet's triplet
    weights, in a batch without triplets, get zeros."""
    tc = smoke_config(arch)
    tp = td.init_model(tc, 0, 8, device="cpu")
    tp["stray"] = torch.ones(3)
    jc = j_smoke_config(arch)
    _, tt = _trips(jc, graph)
    with pytest.raises(RuntimeError):
        td.make_train_step(tc, "full_graph")(
            tp, t_opt.init_adamw(tp),
            {"graph": _port_graph(graph), "triplets": tt})
