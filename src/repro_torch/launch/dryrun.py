"""H100 dry run: count every (arch x shape) cell of ``configs.all_cells()``
on one card (the port of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun [--mesh h100|singlepod|multipod|all]
        [--arch A] [--shape S] [--device cpu] [--variant V] [--out DIR]
        [--force] [--jobs N] [--cells all|traced|probed]

One JSON record per cell goes to
``results/dryrun_h100/<mesh>/<arch>__<shape>.json`` (``--out``);
``roofline/analysis.py`` reads them.

The reference lowers and compiles each cell's step on 512 fake TPU devices
and reads XLA's cost and memory analyses. Eager PyTorch has no compiled
program: what the card does is the sequence of operators the step
dispatches, so the port runs the step under ``roofline.trace.Counter`` and
counts it. On the ``h100`` mesh (one card holds the whole cell):

- **LM and xDeepFM cells are traced on the meta device** at their full
  shape, depth and batch: the model's own ``init`` builds the parameters
  on meta (no memory), the step runs there and every operator is counted.
  The LM train step takes the reference's accumulation rule (``accum =
  min(per-device batch, 8)``); prefill, decode and long_500k run
  ``lm.prefill`` / ``lm.decode_step``. Data-dependent set-up takes its
  worst case (every id distinct in a transpose's rows, every cache
  position valid), which the record lists under ``assumptions``: the
  bytes are an upper bound of a run's.
- **GNN cells run probes on the device given** (``--device``): the GNN
  engine reads its row pointers on the host, which meta tensors do not
  have. A probe is the cell shrunk uniformly by a power of two ``s``:
  ``s`` times the nodes and edges (the cell's degree and feature width;
  DimeNet's triplets capped at 8 an edge as the reference's), ``s``
  times the engine's block and chunk budgets (``gnn.common.
  scaled_budgets``), so it runs the cell's blocks and chunks at a
  fraction of their rows. Each probe takes one train step through
  ``driver.make_train_step``, counted, at 1 and at 2 layers and two
  sizes, ``s`` and ``s / 2``. Every count, the peak included, is then
  ``a + b·s + L·(c + d·s)`` exactly up to rounding, and the four probes
  give the cell at ``s = 1`` and its layers (``extrapolate``), as the
  reference's ``_ring_extrapolate`` takes a ring's rounds. The peak is
  modelled so, not scaled: the chunk and block temporaries are in the
  probes at their shrunk budgets.

Each record holds the parameters counted from the tree (not
``param_count()``: the reference's ``RecsysConfig.param_count`` leaves out
``linear_w``), the optimizer state's bytes, FLOPs by dtype class, bytes,
the peak live bytes and ``fits`` against the card's 80 GB, the reference's
model FLOPs and ``useful_ratio``, the roofline terms (``analysis.terms``)
and the assumptions.

On ``singlepod`` (16, 16) and ``multipod`` (2, 16, 16), the reference's
grids counted over H100s, a record holds each device's parameter and
optimizer bytes from ``sharding.shard_tree`` over ``param_axes`` (GNN
parameters replicated, as the reference places them; xDeepFM under its
``sharding_overrides``; ``--variant`` the reference's rule variants) and
their ``fits``. Their compute, memory and collective terms are not
counted. The GNN full-graph cells have the layout now (``run_flat`` runs
each data shard's body on its own device, ``sharding.collectives.spmd``),
but counting one shard's body, as the reference's ``_ring_extrapolate``
does, is not written yet; the other mesh bodies hold global tensors on
one controller, so a count per device would describe a layout the code
does not have.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.params import resolve_device
from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shapes
from repro_torch.configs.base import GNNConfig, LMConfig, ShapeSpec
from repro_torch.roofline import analysis
from repro_torch.roofline.trace import Counter
from repro_torch.sharding.rules import rule_overrides, shard_tree

RESULTS_DIR = analysis.RESULTS_DIR
MESHES = ("h100", "singlepod", "multipod")
GRID_NOT_COUNTED = (
    "not counted: the port's mesh bodies hold global tensors on one "
    "controller (ROADMAP.md Queue 1, the torch.distributed/NCCL backend), "
    "so a per-device count would describe a layout the code does not have")
GRID_RING_NOT_COUNTED = (
    "not counted yet: the GNN ring runs each data shard's body on its own "
    "device (run_flat over sharding.collectives.spmd), but counting one "
    "shard's body (the reference's _ring_extrapolate) is queued "
    "(ROADMAP.md Queue 1)")
# a failure raised by a kernel wrapper's input check: the card refuses the
# cell's shape (a record of its own, not a fault of the dry run)
KERNEL_CHECKS = ("decode_attention:", "segment_sum", "probe_scan:",
                 "shared_scan:")
# the GNN probes' edges at the larger size, at most, by device
PROBE_EDGES = {"cuda": 1 << 17, "cpu": 1 << 15}
PROBE_LAYERS = (1, 2)
PROBE_MAX_BLOCKS = 64          # blocks (and chunks) of a layer in a probe
TRIPLETS_PER_EDGE = 8          # DimeNet's triplet cap (the reference's 8·E)
MINIBATCH_D_FEAT = 602         # the reference dry run's minibatch width

# sharding-rule variants (the reference's ``RULE_VARIANTS``)
RULE_VARIANTS = {
    "baseline": {},
    "fsdp": {
        "batch": ("pod", "data", "model"),
        "heads": None, "kv_heads": None, "mlp": None, "act_heads": None,
        "embed_fsdp": ("data", "model"),
        "vocab": ("data", "model"),
        "vocab_act": None,
        "embed_model": None,
        "experts": None,
    },
    "serve": {
        "embed_fsdp": None,
    },
}


# ---------------------------------------------------------------------------
# parameters and their logical axes
# ---------------------------------------------------------------------------

def gnn_cell_dims(shape: ShapeSpec) -> dict:
    """The reference dry run's graph of a GNN cell: kind, graphs, nodes and
    edges a graph, input width and outputs."""
    from repro_torch.models.gnn.driver import N_CLASSES
    from repro_torch.sparse.sampler import sizes_for_fanout
    if shape.kind == "full_graph":
        return dict(kind="full_graph", graphs=1, n=shape["n_nodes"],
                    e=shape["n_edges"], d_feat=shape.dims.get("d_feat", 16),
                    n_out=N_CLASSES)
    if shape.kind == "molecule":
        return dict(kind="molecule", graphs=shape["batch"], n=shape["n_nodes"],
                    e=shape["n_edges"], d_feat=4, n_out=1)
    n, e = sizes_for_fanout((shape["fanout0"], shape["fanout1"]))
    return dict(kind="minibatch", graphs=shape["batch_nodes"], n=n, e=e,
                d_feat=min(shape.dims.get("d_feat", MINIBATCH_D_FEAT),
                           MINIBATCH_D_FEAT),
                n_out=N_CLASSES)


def init_params(cfg, shape: Optional[ShapeSpec] = None, device="meta",
                seed: int = 0):
    """The model's own ``init`` on ``device`` (meta: no memory). A GNN takes
    its input width and outputs from ``shape`` (the first cell's without)."""
    if isinstance(cfg, LMConfig):
        from repro_torch.models.lm import init_lm
        return init_lm(cfg, seed, device=device)
    if isinstance(cfg, GNNConfig):
        from repro_torch.models.gnn import driver
        dims = gnn_cell_dims(shape or get_shapes(cfg.arch_id)[0])
        return driver.init_model(cfg, seed, dims["d_feat"], dims["n_out"],
                                 device=device)
    from repro_torch.models.recsys import xdeepfm
    return xdeepfm.init(cfg, seed, device=device)


_GQA_AXES = {
    "wq": ("embed_fsdp", "heads", "head_dim"),
    "wk": ("embed_fsdp", "kv_heads", "head_dim"),
    "wv": ("embed_fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed_fsdp"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
}
_MLA_AXES = {
    "wq": ("embed_fsdp", "heads", "head_dim"),
    "w_dkv": ("embed_fsdp", "kv_lora"),
    "w_krope": ("embed_fsdp", "head_dim"),
    "w_uk": ("kv_lora", "heads", "head_dim"),
    "w_uv": ("kv_lora", "heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed_fsdp"),
}
_SWIGLU_AXES = {"w1": ("embed_fsdp", "mlp"), "w3": ("embed_fsdp", "mlp"),
                "w2": ("mlp", "embed_fsdp")}
_MOE_AXES = {"wr": (None, None), "w1": ("experts", "embed_fsdp", "mlp"),
             "w3": ("experts", "embed_fsdp", "mlp"),
             "w2": ("experts", "mlp", "embed_fsdp")}
_RECSYS_AXES = {"tables": (None, "table", None), "linear_w": (None, "table"),
                "bias": (None,), "cin_out": (None, None),
                "mlp_out": (None, None)}


def _lm_layer_axes(cfg, lp: dict) -> dict:
    attn = _MLA_AXES if cfg.attention == "mla" else _GQA_AXES
    out = {"attn": {k: attn[k] for k in lp["attn"]},
           "ln1": (None,), "ln2": (None,)}
    for group in ("ffn", "shared"):
        if group in lp:
            out[group] = {k: _SWIGLU_AXES[k] for k in lp[group]}
    if "moe" in lp:
        out["moe"] = {k: _MOE_AXES[k] for k in lp["moe"]}
    return out


def _recsys_axes(name: str):
    if name in _RECSYS_AXES:
        return _RECSYS_AXES[name]
    if name.startswith("cin_w"):
        return (None, None, None)
    if name.startswith("mlp_w"):
        return (None, "mlp")
    return (None,)                                   # mlp_b{k}


def param_axes(cfg, params=None):
    """The logical axes of each parameter, a tree of the params' structure
    (``params``: the model's tree, built on meta when None). The LM's and
    xDeepFM's are the reference's ``init`` axes leaf by leaf (a stacked
    layer's without its leading layer axis, since the port keeps a list of
    layers); GNN parameters are replicated, as the reference's dry run
    places them (every axis None)."""
    params = init_params(cfg) if params is None else params
    if isinstance(cfg, LMConfig):
        out = {"embed": ("vocab", None) if cfg.tie_embeddings
               else (None, "embed_model"), "final_ln": (None,),
               "layers": [_lm_layer_axes(cfg, lp) for lp in params["layers"]]}
        if "head" in params:
            out["head"] = (None, "vocab")
        return out
    if isinstance(cfg, GNNConfig):
        return tree_map(lambda t: (None,) * t.dim(), params)
    return {k: _recsys_axes(k) for k in params}


def per_device_bytes(params, axes, mesh) -> int:
    """Bytes of one device's shard of every leaf, under ``shard_tree`` with
    the rule overrides active at the call."""
    def one(t, sh):
        n = t.element_size()
        for dim, ax in zip(t.shape, sh.spec):
            names = () if ax is None else (ax,) if isinstance(ax, str) else ax
            n *= -(-dim // int(np.prod([mesh.shape[a] for a in names] or [1])))
        return n

    return int(sum(leaves(tree_map(one, params,
                                   shard_tree(axes, params, mesh)))))


def tree_numel(params) -> int:
    return int(sum(t.numel() for t in leaves(params)))


def opt_state_bytes(n_params: int) -> int:
    """AdamW's fp32 moments (two a parameter) and its int32 step."""
    return 8 * n_params + 4


# ---------------------------------------------------------------------------
# the reference's model FLOPs and accumulation rule
# ---------------------------------------------------------------------------

def lm_accum(global_batch: int, n_data: int = 1) -> int:
    """Micro-batches of an LM train step (the reference's rule: at most 8,
    at most one sequence a micro-batch per device)."""
    per_dev = max(global_batch // max(n_data, 1), 1)
    return min(per_dev, 8)


def lm_model_meta(cfg, shape: ShapeSpec) -> dict:
    bsz, seq = shape["global_batch"], shape["seq_len"]
    tokens = bsz * (seq if shape.kind != "decode" else 1)
    mult = 3 if shape.kind == "train" else 1          # fwd+bwd ≈ 3x fwd
    model_flops = 2 * cfg.active_param_count() * tokens * mult
    return {"params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "model_flops": model_flops, "tokens": tokens}


def gnn_model_flops(cfg, n_edges: int, d_feat: int) -> int:
    """Analytic per-forward FLOPs (message matmuls dominate): the
    reference's ``_gnn_model_flops``."""
    d = cfg.d_hidden
    if cfg.model == "egnn":
        per_edge = 2 * (2 * d + 1) * d + 2 * d * d + 2 * d * 1
    elif cfg.model == "dimenet":
        nb, ns, nr = cfg.n_bilinear, cfg.n_spherical, cfg.n_radial
        per_edge = (2 * 3 * d * d
                    + 8 * (2 * d * d + 2 * ns * nr * nb + 2 * d * nb * d))
    elif cfg.model == "nequip":
        dim = (cfg.l_max + 1) ** 2
        n_paths = sum(min(l1 + l2, cfg.l_max) + 1 - abs(l1 - l2)
                      for l1 in range(cfg.l_max + 1)
                      for l2 in range(cfg.l_max + 1)
                      if abs(l1 - l2) <= cfg.l_max)
        per_edge = n_paths * 2 * d * dim * 3
    else:  # equiformer_v2
        dim = (cfg.l_max + 1) ** 2
        so2 = sum((2 if m else 1) * 2 * ((cfg.l_max + 1 - m) * d) ** 2
                  for m in range(cfg.m_max + 1))
        rot = 2 * sum((2 * l + 1) ** 2 * d for l in range(cfg.l_max + 1))
        per_edge = 2 * (so2 + 2 * rot)
    return int(per_edge) * int(n_edges) * cfg.n_layers


def gnn_model_meta(cfg, shape: ShapeSpec) -> dict:
    """The reference's GNN cell meta: 3x the forward's model FLOPs over the
    cell's edges (every graph's, for a batch of graphs)."""
    dims = gnn_cell_dims(shape)
    n_edges = dims["graphs"] * dims["e"]
    return {"model_flops": gnn_model_flops(cfg, n_edges, dims["d_feat"]) * 3}


def recsys_model_meta(cfg, shape: ShapeSpec) -> dict:
    m, d = cfg.n_sparse, cfg.embed_dim
    prev, per_ex = m, 0
    for h in cfg.cin_layers:
        per_ex += 2 * prev * m * d * h
        prev = h
    d_in = m * d
    for h in cfg.mlp_layers:
        per_ex += 2 * d_in * h
        d_in = h
    if shape.kind == "retrieval":
        per_ex = 2 * m * d
        rows = shape["n_candidates"]
    else:
        rows = shape["batch"]
    mult = 3 if shape.kind == "train" else 1
    return {"params": cfg.param_count(), "model_flops": per_ex * rows * mult}


def model_meta(cfg, shape: ShapeSpec) -> dict:
    if isinstance(cfg, LMConfig):
        return lm_model_meta(cfg, shape)
    if isinstance(cfg, GNNConfig):
        return gnn_model_meta(cfg, shape)
    return recsys_model_meta(cfg, shape)


# ---------------------------------------------------------------------------
# counting on one card
# ---------------------------------------------------------------------------

def _counted(fn, *state) -> dict:
    """``fn()`` under a counter that holds ``state`` live from the start."""
    t0 = time.perf_counter()
    with Counter() as c:
        c.track(*state)
        fn()
    return dict(c.summary(), trace_s=time.perf_counter() - t0)


def lm_cell(cfg, shape: ShapeSpec) -> dict:
    """One LM cell's step traced on meta: train (``make_train_step`` at the
    reference's accumulation), prefill, or one decode step."""
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    meta = torch.device("meta")
    params = lm.init_lm(cfg, 0, device=meta)
    bsz, seq = shape["global_batch"], shape["seq_len"]
    if shape.kind == "train":
        accum = lm_accum(bsz)
        micro = bsz // accum
        dims = (accum, micro, seq) if accum > 1 else (bsz, seq)
        tok = torch.empty(dims, dtype=torch.int32, device=meta)
        opt = init_adamw(params)
        step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=1024,
                                                         remat=True),
                                  AdamWConfig(), grad_accum=accum)
        batch = {"tokens": tok, "labels": tok}
        out = _counted(lambda: step(params, opt, batch), params, opt, batch)
        out["accum"] = accum
        return out
    if shape.kind == "prefill":
        tok = torch.empty((bsz, seq), dtype=torch.int32, device=meta)
        with torch.no_grad():
            return _counted(lambda: lm.prefill(cfg, params, tok), params, tok)
    clen = lm.cache_len_for(cfg, seq)
    cache = lm.init_cache(cfg, bsz, clen, device=meta)
    tok = torch.empty((bsz,), dtype=torch.int32, device=meta)
    with torch.no_grad():
        return _counted(lambda: lm.decode_step(cfg, params, cache, tok,
                                               clen - 1),
                        params, cache, tok)


def recsys_cell(cfg, shape: ShapeSpec) -> dict:
    """One xDeepFM cell traced on meta: a train step, a serve forward or a
    retrieval scoring."""
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.train.optimizer import init_adamw
    meta = torch.device("meta")
    params = xdeepfm.init(cfg, 0, device=meta)
    f = cfg.n_sparse
    if shape.kind == "train":
        bsz = shape["batch"]
        batch = {"ids": torch.empty((bsz, f), dtype=torch.int32, device=meta),
                 "labels": torch.empty((bsz,), dtype=torch.int32,
                                       device=meta)}
        opt = init_adamw(params)
        step = xdeepfm.make_train_step(cfg)
        return _counted(lambda: step(params, opt, batch), params, opt, batch)
    if shape.kind == "serve":
        ids = torch.empty((shape["batch"], f), dtype=torch.int32, device=meta)
        with torch.no_grad():
            return _counted(lambda: xdeepfm.forward(cfg, params, ids),
                            params, ids)
    user = torch.empty((f,), dtype=torch.int32, device=meta)
    cands = torch.empty((shape["n_candidates"], f), dtype=torch.int32,
                        device=meta)
    with torch.no_grad():
        return _counted(lambda: xdeepfm.retrieval_score(cfg, params, user,
                                                        cands),
                        params, user, cands)


def _tree_batch(graphs: int, n: int, e: int, fanouts, d_feat: int, seed: int,
                device):
    """``graphs`` padded fanout trees as the sampler lays them out (node 0
    the root; children -> parent), every slot filled, random features: a
    minibatch of the cell's shape."""
    from repro_torch.models.gnn.common import FlatGraph
    from repro_torch.models.gnn.driver import N_CLASSES
    src, dst, nxt, frontier = [], [], 1, [0]
    for f in fanouts:
        new = []
        for loc in frontier:
            src.extend(range(nxt, nxt + f))
            dst.extend([loc] * f)
            new.extend(range(nxt, nxt + f))
            nxt += f
        frontier = new
    assert len(src) == e and nxt == n
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pos = rng.normal(size=(graphs, n, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True) + 1e-9
    g = FlatGraph(
        feats=t(rng.normal(size=(graphs, n, d_feat)).astype(np.float32)),
        positions=t(pos),
        edge_src=t(np.tile(np.asarray(src, np.int32), (graphs, 1))),
        edge_dst=t(np.tile(np.asarray(dst, np.int32), (graphs, 1))),
        edge_mask=torch.ones((graphs, e), dtype=torch.bool, device=device),
        node_mask=torch.ones((graphs, n), dtype=torch.bool, device=device),
        labels=torch.zeros((graphs, n), dtype=torch.int32, device=device))
    labels = t(rng.integers(0, N_CLASSES, graphs).astype(np.int32))
    return {"graph": g, "labels": labels}


def gnn_probe_batch(cfg, shape: ShapeSpec, scale: float, device,
                    seed: int = 0) -> dict:
    """The cell's batch shrunk by ``scale``: its graph (or ``scale`` times
    its graphs), on ``device``; a full graph's engine is ``probe_engine``'s."""
    from repro_torch.models.gnn import dimenet, driver
    dims = gnn_cell_dims(shape)
    is_dn = cfg.model == "dimenet"
    if dims["kind"] == "full_graph":
        n = max(2, round(dims["n"] * scale))
        e = max(1, round(dims["e"] * scale))
        g = driver.make_flat_graph(n, e, dims["d_feat"], seed, device=device)
        batch = {"graph": g}
        if is_dn:
            batch["triplets"] = dimenet.build_triplets(
                *(t.cpu().numpy() for t in (g.edge_src, g.edge_dst,
                                            g.edge_mask)),
                TRIPLETS_PER_EDGE, device=device)
        return batch
    graphs = max(1, round(dims["graphs"] * scale))
    if dims["kind"] == "molecule":
        g, energy = driver.make_molecule_batch(graphs, dims["n"], dims["e"],
                                               seed, device=device)
        batch = {"graph": g, "energy": energy}
        if is_dn:
            batch["triplets"] = dimenet.build_batch_triplets(
                *(t.cpu().numpy() for t in (g.edge_src, g.edge_dst,
                                            g.edge_mask)),
                TRIPLETS_PER_EDGE, device=device)
        return batch
    return _tree_batch(graphs, dims["n"], dims["e"],
                       (shape["fanout0"], shape["fanout1"]), dims["d_feat"],
                       seed, device)


def probe_engine(cfg, g, scale: float):
    """The engine of a full-graph probe, built with the budgets times
    ``scale``: the cell's blocks and chunks at ``scale`` of their rows.
    Where that gives more than ``PROBE_MAX_BLOCKS`` blocks or chunks a
    layer, the budgets grow by the power of two that brings them under it
    (returned as ``boost``, 1 otherwise): a probe's operators then stay
    few, and its transposes' rows a block are another share of the
    graph's than the cell's."""
    from repro_torch.models.gnn import common, driver
    boost = 1
    while True:
        with common.scaled_budgets(scale * boost):
            ex = driver.engine(cfg, g)
        blocks = -(-ex.n_edges // max(ex.block, 1))
        if max(blocks, len(ex.chunks)) <= PROBE_MAX_BLOCKS or (
                scale * boost >= 1):
            return ex, boost
        boost *= 2


def _engine_tensors(batch) -> list:
    """The tensors a full-graph batch's engine holds (its sort, chunks)."""
    ex = batch.get("exec")
    if ex is None:
        return []
    out = [v for v in vars(ex).values() if isinstance(v, torch.Tensor)]
    for chunks in ex._chunk_lists.values():
        out.extend(c[4] for c in chunks)
    return out


def gnn_probe(cfg, shape: ShapeSpec, scale: float, layers: int, device,
              train: bool = True) -> dict:
    """One probe: the cell shrunk by ``scale`` at ``layers`` layers, one
    train step (or, ``train`` False, one forward of the loss) counted."""
    from repro_torch.models.gnn import common, driver
    from repro_torch.train.optimizer import init_adamw
    sub = cfg.replace(n_layers=layers)
    dims = gnn_cell_dims(shape)
    boost = 1
    with common.scaled_budgets(scale):
        batch = gnn_probe_batch(sub, shape, scale, device)
    if dims["kind"] == "full_graph":
        batch["exec"], boost = probe_engine(sub, batch["graph"], scale)
    params = driver.init_model(sub, 0, dims["d_feat"], dims["n_out"],
                               device=device)
    kind = dims["kind"]
    state = [params, {k: v for k, v in batch.items() if k != "exec"},
             _engine_tensors(batch)]
    # the loss sizes (NequIP, Equiformer-v2) or builds (minibatch, molecule)
    # its engine from the budgets at the call
    with common.scaled_budgets(scale * boost):
        if train:
            opt = init_adamw(params)
            step = driver.make_train_step(sub, kind)
            out = _counted(lambda: step(params, opt, batch), opt, *state)
        else:
            def fwd():
                with torch.no_grad():
                    driver.train_loss(sub, kind, params, batch)
            out = _counted(fwd, *state)
    if boost > 1:
        out["assumptions"] = out["assumptions"] + [
            f"probe budgets {boost}x the scaled ones (at most "
            f"{PROBE_MAX_BLOCKS} blocks and chunks a layer in a probe)"]
    g = batch["graph"]
    out.update(scale=scale, layers=layers,
               nodes=int(g.feats.shape[0] * (g.feats.shape[1]
                                             if g.feats.dim() == 3 else 1)),
               edges=int(g.edge_src.numel()))
    return out


def extrapolate(probes: List[dict], target_scale: float, target_layers: int,
                key) -> float:
    """``f(s, L) = a + b·s + L·(c + d·s)`` through the four probes (two
    scales by two depths) at ``(target_scale, target_layers)``."""
    (s0, s1) = sorted({p["scale"] for p in probes})
    (l0, l1) = sorted({p["layers"] for p in probes})
    f = {(p["scale"], p["layers"]): float(key(p)) for p in probes}
    u = (target_scale - s0) / (s1 - s0)
    v = (target_layers - l0) / (l1 - l0)
    return ((1 - u) * (1 - v) * f[(s0, l0)] + u * (1 - v) * f[(s1, l0)]
            + (1 - u) * v * f[(s0, l1)] + u * v * f[(s1, l1)])


def probe_scales(shape: ShapeSpec, probe_edges: int) -> tuple:
    """(s / 2, s): s the largest power of two (at most 1) whose probe has
    at most ``probe_edges`` edges."""
    dims = gnn_cell_dims(shape)
    total = dims["graphs"] * dims["e"]
    s = 2.0 ** min(0, math.floor(math.log2(max(probe_edges, 1) / total)))
    return s / 2, s


def gnn_cell(cfg, shape: ShapeSpec, device, train: bool = True,
             probe_edges: Optional[int] = None) -> dict:
    """A GNN cell from its four probes on ``device`` (the module
    docstring): the counts at the cell's size and depth."""
    device = resolve_device(device, "gnn_cell")
    if probe_edges is None:
        probe_edges = PROBE_EDGES["cuda" if device.type == "cuda" else "cpu"]
    t0 = time.perf_counter()
    probes = []
    for layers in PROBE_LAYERS:
        for s in probe_scales(shape, probe_edges):
            p = gnn_probe(cfg, shape, s, layers, device, train)
            probes.append(p)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    L = cfg.n_layers

    def ex(key):
        return extrapolate(probes, 1.0, L, key)

    # operator and launch counts do not grow with the scale where a probe
    # keeps the cell's blocks and chunks: taken along the layers at the
    # larger scale (the smaller one checks that they held)
    big = [p for p in probes if p["scale"] == max(x["scale"] for x in probes)]
    (l0, n0), (l1, n1) = sorted((p["layers"], p["ops"]) for p in big)
    small = {p["layers"]: p["ops"] for p in probes if p not in big}
    kept = all(abs(small[lay] - n) <= 0.02 * n for lay, n in ((l0, n0),
                                                                (l1, n1)))

    def along_layers(key):
        (a0, v0), (a1, v1) = sorted((p["layers"], key(p)) for p in big)
        return v0 + (L - a0) * (v1 - v0) / (a1 - a0)

    flops = {c: max(0.0, ex(lambda p, c=c: p["flops"][c]))
             for c in probes[0]["flops"]}
    kernels = {}
    for name in probes[0]["kernels"]:
        def kern(k, name=name):
            return lambda p: p["kernels"].get(name, {}).get(k, 0.0)
        kernels[name] = {"launches": along_layers(kern("launches")),
                         "flops": ex(kern("flops")),
                         "bytes": ex(kern("bytes"))}
    notes = sorted({a for p in probes for a in p["assumptions"]})
    if not kept:
        notes.append("the probes' operator counts differ by scale (their "
                     "chunks or blocks hold fewer segments than the cell's): "
                     "operator and launch counts are the larger probe's")
    return {
        "flops": flops, "flops_total": sum(flops.values()),
        "bytes": ex(lambda p: p["bytes"]),
        "peak_bytes": ex(lambda p: p["peak_bytes"]),
        "ops": along_layers(lambda p: p["ops"]), "kernels": kernels,
        "collective_bytes_per_device": {"total": 0.0},
        "assumptions": notes,
        "probes": [{k: p[k] for k in ("scale", "layers", "nodes", "edges",
                                      "flops_total", "bytes", "peak_bytes",
                                      "ops", "trace_s")} for p in probes],
        "trace_s": time.perf_counter() - t0,
    }


def count_cell(cfg, shape: ShapeSpec, device=None, train: bool = True,
               probe_edges: Optional[int] = None) -> dict:
    """The counts of one cell on one card (meta trace or probes), without
    the record's bookkeeping: what ``chip_smoke.py`` compares with a run."""
    if isinstance(cfg, LMConfig):
        return dict(lm_cell(cfg, shape), method="traced on meta")
    if isinstance(cfg, GNNConfig):
        return dict(gnn_cell(cfg, shape, device, train, probe_edges),
                    method="extrapolated from probes on " + str(
                        resolve_device(device, "gnn_cell")))
    return dict(recsys_cell(cfg, shape), method="traced on meta")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def _base(arch, shape, mesh_name, variant) -> dict:
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "kind": shape.kind, "dims": shape.dims, "variant": variant}


def state_record(cfg, shape: ShapeSpec) -> dict:
    """Parameters counted from the tree the model's ``init`` builds on meta,
    and the optimizer state a train cell carries."""
    params = init_params(cfg, shape)
    n = tree_numel(params)
    pbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    train = shape.kind in ("train", "full_graph", "molecule", "minibatch")
    return {"params": n, "param_bytes": pbytes,
            "opt_state_bytes": opt_state_bytes(n) if train else 0}


def h100_record(arch: str, shape: ShapeSpec, device=None,
                probe_edges: Optional[int] = None) -> dict:
    cfg = get_config(arch)
    rec = _base(arch, shape, "h100", "baseline")
    rec["devices"] = 1
    if shape.skip:
        return dict(rec, status="skipped", skip_reason=shape.skip_reason)
    rec.update(state_record(cfg, shape))
    counts = count_cell(cfg, shape, device, True, probe_edges)
    meta = model_meta(cfg, shape)
    total = counts["flops_total"]
    rec.update(counts)
    rec.update(
        status="ok", meta=meta,
        useful_ratio=meta["model_flops"] / total if total else 0.0,
        hbm_bytes=analysis.HBM_BYTES,
        fits=bool(counts["peak_bytes"] <= analysis.HBM_BYTES),
        **analysis.terms(counts["flops"], counts["bytes"], 0.0))
    return rec


def grid_record(arch: str, shape: ShapeSpec, mesh_name: str,
                variant: str = "baseline") -> dict:
    """Per-device parameter and optimizer bytes on the reference's grids."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch)
    rec = _base(arch, shape, mesh_name, variant)
    if shape.skip:
        return dict(rec, status="skipped", skip_reason=shape.skip_reason)
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod",
                                devices=["meta"])
    rec["devices"] = int(np.prod(list(mesh.shape.values())))
    params = init_params(cfg, shape)
    axes = param_axes(cfg, params)
    overrides = {**getattr(cfg, "sharding_overrides", {}),
                 **RULE_VARIANTS[variant]}
    with rule_overrides(overrides):
        pbytes = per_device_bytes(params, axes, mesh)
        moments = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                                 device="meta"), params)
        obytes = 2 * per_device_bytes(moments, axes, mesh) + 4
    train = shape.kind in ("train", "full_graph", "molecule", "minibatch")
    state = pbytes + (obytes if train else 0)
    rec.update(status="ok", params=tree_numel(params),
               param_bytes_per_device=pbytes,
               opt_state_bytes_per_device=obytes if train else 0,
               state_bytes_per_device=state, hbm_bytes=analysis.HBM_BYTES,
               fits=bool(state <= analysis.HBM_BYTES),
               meta=model_meta(cfg, shape))
    text = (GRID_RING_NOT_COUNTED if shape.kind == "full_graph"
            else GRID_NOT_COUNTED)
    rec.update(compute=text, memory=text, collective=text)
    return rec


def run_cell(arch: str, shape: ShapeSpec, mesh_name: str, device=None,
             variant: str = "baseline") -> dict:
    if mesh_name == "h100":
        return h100_record(arch, shape, device)
    return grid_record(arch, shape, mesh_name, variant)


def failed_record(arch, shape, mesh_name, e: BaseException) -> dict:
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "status": "failed", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def refused_by_kernel(rec: dict) -> bool:
    """A failed record whose error is a kernel wrapper's input check."""
    return rec["error"].startswith("ValueError: ") and rec["error"][
        len("ValueError: "):].startswith(KERNEL_CHECKS)


def summary_line(rec: dict) -> str:
    head = f"{rec['mesh']:9s} {rec['arch']:22s} {rec['shape']:14s}"
    if rec["status"] == "skipped":
        return f"[skip]   {head} ({rec['skip_reason'][:60]})"
    if rec["status"] == "failed":
        return f"[FAIL]   {head} {rec['error'][:120]}"
    if rec["mesh"] == "h100":
        return (f"[ok]     {head} flops={rec['flops_total']:.3e} "
                f"bytes={rec['bytes']:.3e} "
                f"peak={rec['peak_bytes'] / 2 ** 30:.2f}GiB "
                f"fits={rec['fits']} bound={rec['bound_ms']:.3f}ms "
                f"({rec['dominant']})")
    return (f"[ok]     {head} state/dev="
            f"{rec['state_bytes_per_device'] / 2 ** 30:.2f}GiB "
            f"fits={rec['fits']}")


def _is_probed(arch: str) -> bool:
    return isinstance(get_config(arch), GNNConfig)


def _run_and_write(arch, shape_name, mesh_name, device, variant, path):
    shape = next(s for s in get_shapes(arch) if s.name == shape_name)
    try:
        rec = run_cell(arch, shape, mesh_name, device, variant)
    except Exception as e:  # noqa: BLE001
        rec = failed_record(arch, shape, mesh_name, e)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="h100", choices=list(MESHES) + ["all"])
    ap.add_argument("--device", default=None,
                    help="where the GNN probes run (default: the card)")
    ap.add_argument("--variant", default="baseline",
                    choices=list(RULE_VARIANTS))
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes for the cells traced on meta")
    ap.add_argument("--cells", default="all",
                    choices=["all", "traced", "probed"],
                    help="the cells traced on meta, the GNN cells probed "
                         "on the device, or both")
    args = ap.parse_args(argv)
    if args.variant != "baseline":
        args.out = args.out.rstrip("/") + "_" + args.variant
    device = resolve_device(args.device, "the dry run's GNN probes") \
        if args.cells != "traced" else torch.device("meta")
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)

    todo = []
    for arch in archs:
        for shape in get_shapes(arch):
            if args.shape and shape.name != args.shape:
                continue
            for mesh_name in meshes:
                probed = mesh_name == "h100" and _is_probed(arch)
                if (args.cells == "traced" and probed) or (
                        args.cells == "probed" and not probed):
                    continue
                os.makedirs(os.path.join(args.out, mesh_name), exist_ok=True)
                path = os.path.join(args.out, mesh_name,
                                    f"{arch}__{shape.name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {mesh_name:9s} {arch:22s} {shape.name}")
                    continue
                todo.append((arch, shape.name, mesh_name, probed, path))

    counts = {"ok": 0, "skipped": 0, "failed": 0, "refused": 0}

    def done(rec):
        counts[rec["status"]] += 1
        if rec["status"] == "failed" and refused_by_kernel(rec):
            counts["refused"] += 1
        print(summary_line(rec), flush=True)

    pool_jobs = [t for t in todo if not t[3]]
    if args.jobs > 1 and len(pool_jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futs = [pool.submit(_run_and_write, a, s, m, "meta",
                                args.variant, p)
                    for a, s, m, _, p in pool_jobs]
            for fut in futs:
                done(fut.result())
        todo = [t for t in todo if t[3]]
    for arch, shape_name, mesh_name, probed, path in todo:
        done(_run_and_write(arch, shape_name, mesh_name,
                            device if probed else "meta", args.variant, path))
    print(f"\ndone: ok={counts['ok']} skipped={counts['skipped']} "
          f"failed={counts['failed']} (refused by a kernel's check: "
          f"{counts['refused']})")
    return 0 if counts["failed"] == counts["refused"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
