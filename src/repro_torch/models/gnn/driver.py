"""GNN driver of the port (``repro.models.gnn.driver``): synthetic graph
builders, model dispatch (EGNN), the losses of the three layouts
(full_graph / minibatch / molecule) and their train steps.

The graph builders draw from numpy exactly as the reference does, so the
same seed gives the same arrays, placed on ``device`` (None = the CUDA
device). ``molecule_loss`` and ``minibatch_loss`` run a batch of small
graphs (molecules, or the sampler's fanout trees) as one disjoint-union
graph (node ids of graph b offset by b·n), so one kernel launch per chunk
and layer serves the whole batch where the reference ``vmap``s over
graphs; the sums agree.

``make_train_step`` returns ``step(params, opt_state, batch) -> (new
params, new opt state, metrics)``: the gradient of ``train_loss`` through
the differentiable segment sum and ``LocalExec``'s checkpointed blocks,
then ``adamw_update``. It returns new trees and leaves its inputs as they
were, as the reference's functional step does. A full-graph batch may
carry ``"exec"``, a ``LocalExec`` built on its graph once and reused
across steps.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.params import resolve_device
from repro_torch.common.tree import leaves, tree_map
from repro_torch.models.gnn import egnn as egnn_mod
from repro_torch.models.gnn.common import FlatGraph, LocalExec, run_flat
from repro_torch.train.optimizer import AdamWConfig, adamw_update

N_CLASSES = 16

_MODELS = {"egnn": egnn_mod}


def _module(cfg):
    if cfg.model not in _MODELS:
        raise NotImplementedError(
            f"GNN model {cfg.model!r} is not ported to repro_torch yet "
            "(ROADMAP.md Queue 1 item 17; EGNN is)")
    return _MODELS[cfg.model]


def make_flat_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                    n_classes: int = N_CLASSES, *, device=None) -> FlatGraph:
    """Synthetic flat graph; unit-sphere positions (geometric archs on
    non-geometric graphs). The reference's draws, on ``device``."""
    device = resolve_device(device, "make_flat_graph")
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True) + 1e-9
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = np.where(dst == src, (dst + 1) % n_nodes, dst)   # no self-loops
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return FlatGraph(
        feats=t(feats), positions=t(pos), edge_src=t(src), edge_dst=t(dst),
        edge_mask=torch.ones((n_edges,), dtype=torch.bool, device=device),
        node_mask=torch.ones((n_nodes,), dtype=torch.bool, device=device),
        labels=t(labels))


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int,
                        seed: int = 0, *, device=None):
    """Batched small graphs as a leading-B FlatGraph + regression targets."""
    device = resolve_device(device, "make_molecule_batch")
    rng = np.random.default_rng(seed)
    gs = [make_flat_graph(n_nodes, n_edges, 4, seed=seed + i, device=device)
          for i in range(batch)]
    stacked = FlatGraph(*(torch.stack(xs) for xs in zip(*gs)))
    energy = torch.from_numpy(rng.normal(size=(batch,)).astype(np.float32))
    return stacked, energy.to(device)


def disjoint_union(batched_g: FlatGraph) -> FlatGraph:
    """(B, n, ...) graphs -> one graph of B·n nodes whose edges keep to
    their own graph (ids offset by b·n; padded ids stay negative)."""
    b, n = batched_g.feats.shape[:2]
    off = (torch.arange(b, device=batched_g.feats.device,
                        dtype=torch.int32) * n)[:, None]

    def ids(e):
        return torch.where(e >= 0, e + off, e).reshape(-1)

    return FlatGraph(
        feats=batched_g.feats.reshape(b * n, -1),
        positions=batched_g.positions.reshape(b * n, -1),
        edge_src=ids(batched_g.edge_src), edge_dst=ids(batched_g.edge_dst),
        edge_mask=batched_g.edge_mask.reshape(-1),
        node_mask=batched_g.node_mask.reshape(-1),
        labels=batched_g.labels.reshape(-1))


def init_model(cfg, seed: int, d_feat_in: int, n_out: int = N_CLASSES, *,
               device=None):
    """Seeded parameters (the reference's ``init_model`` takes a PRNG key
    and also returns logical axes; the port returns the params only)."""
    return _module(cfg).init(cfg, seed, d_feat_in, n_out, device=device)


def node_logits_local(cfg, params, g: FlatGraph, triplets=None,
                      ex: Optional[LocalExec] = None) -> torch.Tensor:
    """(N, n_out) logits. ``ex``: a ``LocalExec`` built on ``g`` once and
    reused across forwards (the destination sort is set-up); None builds
    one."""
    mod = _module(cfg)
    if triplets is not None:
        raise NotImplementedError("triplets (DimeNet) are not ported yet "
                                  "(ROADMAP.md Queue 1 item 17)")
    ex = LocalExec(g) if ex is None else ex
    return mod.node_logits(cfg, params, g.feats, g.positions, g.node_mask, ex)


# ---------------------------------------------------------------------------
# losses (forward)
# ---------------------------------------------------------------------------

def _ce_sums(logits, labels, mask) -> Dict[str, torch.Tensor]:
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lp, -1, labels[..., None].to(torch.int64))[..., 0]
    ok = mask.to(torch.float32)
    correct = (torch.argmax(logits, -1) == labels).to(torch.float32) * ok
    return {"loss_sum": -torch.sum(ll * ok), "correct": torch.sum(correct),
            "count": torch.sum(ok)}


def full_graph_loss(cfg, params, g: FlatGraph, mesh=None, triplets=None,
                    ex: Optional[LocalExec] = None):
    """CE sums over labelled nodes of one graph (single device)."""
    if mesh is not None:
        return run_flat(None, g, params, mesh)       # raises: Queue 1 item 15
    logits = node_logits_local(cfg, params, g, triplets, ex)
    return _ce_sums(logits, g.labels, g.node_mask)


def molecule_loss(cfg, params, batched_g: FlatGraph, energy, triplets=None):
    """MSE sums on per-graph energies (masked scalar sum-pool), the batch run
    as one disjoint-union graph."""
    b, n = batched_g.feats.shape[:2]
    logits = node_logits_local(cfg, params, disjoint_union(batched_g),
                               triplets)
    pred = (logits[:, 0] * batched_g.node_mask.reshape(-1)).reshape(b, n)
    pred = pred.sum(-1)
    return {"loss_sum": torch.sum((pred - energy) ** 2),
            "count": torch.tensor(float(energy.shape[0]),
                                  device=energy.device)}


def minibatch_loss(cfg, params, batched_g: FlatGraph, root_labels):
    """CE on each sampled tree's root node (local index 0), the trees run
    as one disjoint-union graph: tree b's root is node b·n_sub."""
    b, n = batched_g.feats.shape[:2]
    logits = node_logits_local(cfg, params, disjoint_union(batched_g))
    roots = logits.reshape(b, n, -1)[:, 0]                   # (B, n_classes)
    return _ce_sums(roots, root_labels,
                    torch.ones(root_labels.shape, dtype=torch.float32,
                               device=root_labels.device))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def train_loss(cfg, kind: str, params, batch):
    """(loss, sums) of one batch on one device: ``loss_sum / max(count,
    1)``."""
    if kind == "full_graph":
        sums = full_graph_loss(cfg, params, batch["graph"], None,
                               batch.get("triplets"), ex=batch.get("exec"))
    elif kind == "molecule":
        sums = molecule_loss(cfg, params, batch["graph"], batch["energy"],
                             batch.get("triplets"))
    elif kind == "minibatch":
        sums = minibatch_loss(cfg, params, batch["graph"], batch["labels"])
    else:
        raise ValueError(kind)
    loss = sums["loss_sum"] / torch.clamp(sums["count"], min=1.0)
    return loss, sums


def make_train_step(cfg, kind: str, mesh=None,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3)):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    metrics are ``loss``, the loss sums, ``grad_norm`` and ``lr``."""
    if mesh is not None:
        raise NotImplementedError(
            "GNN training over a mesh (RingGraph / RingExec) is not ported "
            "to repro_torch yet (ROADMAP.md Queue 1 item 15)")

    def step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, sums = train_loss(cfg, kind, live, batch)
            grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in sums.items()}, **om}
        return params, opt_state, metrics

    return step
