"""DimeNet — directional message passing with triplet angular bases
(Klicpera et al., arXiv:2003.03123), the port of
``repro.models.gnn.dimenet``'s single-graph path.

Messages live on *edges*; an interaction block aggregates over triplets
(k→j→i): incoming messages m_kj are modulated by a joint spherical-Bessel ×
Legendre basis of (d_kj, angle_kji) through a bilinear layer.

Triplet lists are built on the host, capacity-bounded
(``cap_per_edge``), in vectorised numpy that returns the reference's
arrays exactly (its loop visits each valid edge ji in order and keeps the
first ``cap_per_edge`` in-edges kj of j in edge order, skipping k = i). Both
sums run on the CUDA segment-sum kernel: triplets to edges and edges to
nodes, each over a CSR built once per forward (a triplet list comes out
sorted by its edge ji). Under grad the gathers of rows that take a
gradient (``h`` by both endpoints, ``m`` by the triplets' kj) go through
``sparse.segment.gather_rows``: their transposes add in place with the
second kernel, so a step repeats bit for bit.

Parameters are the reference's dict: ``enc``, ``rbf_lin``,
``edge_embed.{w0, b0, w1, b1}``, ``blocks[i].{w_msg, w_sbf, w_bilinear,
update, out_node}``, ``head``.

The ring path (``build_triplet_ring``, ``ring_loss``,
``node_logits_ring``): edges become entities of a line graph laid out per
shard as the node ring's (R·E_cap) slots; each shard runs on its own
node blocks (``common.run_shards``), where a node ring (``RingShard``
without a "model" split) fetches each edge's source rows, and a
line-graph ring over the triplets (kj -> ji, grouped by the round of
kj's owner, split over "model") aggregates the triplet messages into the
edges. ``build_triplet_ring`` gives the reference's arrays bit for bit
from one ``build_triplets_np`` over the ring's edge instances.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.params import Init, resolve_device
from repro_torch.equivariant.bessel import (angular_basis, radial_bessel_basis,
                                            spherical_bessel_basis)
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import csr_from_ids
from repro_torch.models.gnn.common import RingExec, run_shards, to_ring
from repro_torch.sparse.segment import gather_rows


class TripletIndex(NamedTuple):
    t_src: torch.Tensor    # (T,) int32 — index of edge kj
    t_dst: torch.Tensor    # (T,) int32 — index of edge ji
    t_mask: torch.Tensor   # (T,) bool


def build_triplets_np(edge_src, edge_dst, edge_mask, cap_per_edge: int = 8):
    """(t_src, t_dst, t_mask) numpy: for each valid edge ji, up to
    ``cap_per_edge`` valid in-edges kj of node j (k ≠ i; a skipped kj does
    not count toward the cap), ji ascending and kj in edge order, padded to
    a multiple of 8 with (0, 0, False) (at least 8)."""
    src = np.asarray(edge_src).astype(np.int64)
    dst = np.asarray(edge_dst).astype(np.int64)
    valid = np.flatnonzero(np.asarray(edge_mask, bool))
    # the in-edges of each node in edge order: valid edges, stably by dst
    by_dst = valid[np.argsort(dst[valid], kind="stable")]
    keys = dst[by_dst]
    j = src[valid]
    lo = np.searchsorted(keys, j, "left")
    cnt = np.searchsorted(keys, j, "right") - lo
    first = np.cumsum(cnt) - cnt               # each ji's first candidate
    ji = np.repeat(valid, cnt)
    kj = by_dst[np.arange(int(cnt.sum())) + np.repeat(lo - first, cnt)]
    keep = src[kj] != dst[ji]                  # no backtracking k == i
    kept = np.cumsum(keep)
    rank = kept - np.concatenate([[0], kept])[np.repeat(first, cnt)]
    keep &= rank <= cap_per_edge
    n_t = int(keep.sum())
    t = max(n_t, 1)
    size = t + (-t) % 8
    ts = np.zeros(size, np.int32)
    td = np.zeros(size, np.int32)
    tm = np.zeros(size, bool)
    ts[:n_t] = kj[keep]
    td[:n_t] = ji[keep]
    tm[:n_t] = True
    return ts, td, tm


def build_triplets(edge_src, edge_dst, edge_mask, cap_per_edge: int = 8, *,
                   device=None) -> TripletIndex:
    """Host-side: ``build_triplets_np``'s arrays on ``device`` (None = the
    CUDA device)."""
    device = resolve_device(device, "build_triplets")
    return TripletIndex(*(torch.from_numpy(a).to(device) for a in
                          build_triplets_np(edge_src, edge_dst, edge_mask,
                                            cap_per_edge)))


def build_batch_triplets(edge_src, edge_dst, edge_mask,
                         cap_per_edge: int = 8, *, device=None
                         ) -> TripletIndex:
    """A batch of graphs' (B, E) edge arrays -> (B, T) triplets: each
    graph's ``build_triplets_np``, padded with (0, 0, False) to the longest
    (the reference's ``vmap`` over graphs takes them so)."""
    device = resolve_device(device, "build_batch_triplets")
    per = [build_triplets_np(s, d, m, cap_per_edge)
           for s, d, m in zip(np.asarray(edge_src), np.asarray(edge_dst),
                              np.asarray(edge_mask))]
    t = max(len(p[0]) for p in per)
    out = [np.zeros((len(per), t), dt) for dt in (np.int32, np.int32, bool)]
    for b, arrays in enumerate(per):
        for o, a in zip(out, arrays):
            o[b, :len(a)] = a
    return TripletIndex(*(torch.from_numpy(a).to(device) for a in out))


def _init_mlp(init: Init, dims: Sequence[int]):
    p = {}
    for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = init.dense((di, do), fan_in=di)
        p[f"b{i}"] = init.zeros((do,))
    return p


def _apply_mlp(p, x, n: int, final_act: bool = True):
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = F.silu(x)
    return x


def init(cfg, seed: int, d_feat_in: int, n_out: int, *, device=None):
    """Seeded random fp32 parameters on ``device`` (None = the CUDA device).
    The draws differ from the reference's for the same seed: parity goes
    through ``convert.gnn_params_from_jax``."""
    device = resolve_device(device, "dimenet.init")
    d = cfg.d_hidden
    nr, ns, nb = cfg.n_radial, cfg.n_spherical, cfg.n_bilinear
    init = Init(seed, device, torch.float32)
    params = {"enc": init.dense((d_feat_in, d), fan_in=d_feat_in),
              "rbf_lin": init.dense((nr, d), fan_in=nr),
              "edge_embed": _init_mlp(init, (3 * d, d, d))}
    params["blocks"] = [{"w_msg": init.dense((d, d), fan_in=d),
                         "w_sbf": init.dense((ns * nr, nb), fan_in=ns * nr),
                         "w_bilinear": init.dense((d, nb, d), fan_in=d * nb),
                         "update": _init_mlp(init, (d, d, d)),
                         "out_node": _init_mlp(init, (d, d, d))}
                        for _ in range(cfg.n_layers)]
    params["head"] = init.dense((d, n_out), fan_in=d)
    return params


# the block weights that only the triplet interaction reads: a forward
# without triplets does not reach them
TRIPLET_KEYS = ("w_msg", "w_sbf", "w_bilinear", "update")


def engine(cfg, ex):
    """The engine ``node_logits`` runs on: ``ex`` as it is (its sums take
    the CSRs they build, not the engine's chunks)."""
    return ex


def node_logits(cfg, params, feats, positions, node_mask, ex,
                triplets: Optional[TripletIndex] = None):
    """Single-graph path (LocalExec). Edge messages + triplet interactions."""
    g = ex.g
    n, n_e = feats.shape[0], g.edge_src.shape[0]
    # an edge whose endpoint is out of range reaches no node (the
    # reference's sums drop it): it is masked, and a masked edge reads row
    # 0 (its message is zeroed below)
    emask = (g.edge_mask & (g.edge_src >= 0) & (g.edge_src < n)
             & (g.edge_dst >= 0) & (g.edge_dst < n))
    src = torch.where(emask, g.edge_src, 0)
    dst = torch.where(emask, g.edge_dst, 0)
    h = feats @ params["enc"]                                   # (N, d)
    rel = positions.index_select(0, src) - positions.index_select(0, dst)
    dist = torch.where(emask, torch.linalg.vector_norm(rel, dim=-1), 0.0)
    rbf = radial_bessel_basis(dist, cfg.n_radial, cfg.cutoff)   # (E, nr)
    rbf_d = rbf @ params["rbf_lin"]                             # (E, d)
    m = _apply_mlp(params["edge_embed"],
                   torch.cat([gather_rows(h, src), gather_rows(h, dst),
                              rbf_d], -1), 2)
    m = m * emask[:, None]                                      # (E, d)
    node_csr = csr_from_ids(torch.where(emask, dst, -1), n)

    if triplets is not None:
        # joint (distance × angle) basis per triplet
        ts, td, tm = triplets
        v_kj = rel.index_select(0, ts)                          # k -> j
        v_ji = rel.index_select(0, td)                          # j -> i
        cos_a = torch.sum(-v_kj * v_ji, -1) / torch.clamp(
            torch.linalg.vector_norm(v_kj, dim=-1)
            * torch.linalg.vector_norm(v_ji, dim=-1), min=1e-9)
        angle = torch.arccos(torch.clamp(cos_a, -1 + 1e-7, 1 - 1e-7))
        sbf_r = spherical_bessel_basis(dist.index_select(0, ts),
                                       cfg.n_spherical,
                                       cfg.n_radial, cfg.cutoff)  # (T, ns, nr)
        cbf = angular_basis(angle, cfg.n_spherical)             # (T, ns)
        sbf = (sbf_r * cbf[..., None]).reshape(ts.shape[0], -1)  # (T, ns*nr)
        tri_csr = csr_from_ids(torch.where(tm, td, -1), n_e)

    for bp in params["blocks"]:
        if triplets is not None:
            mk = gather_rows(m, ts) @ bp["w_msg"]               # (T, d)
            basis = sbf @ bp["w_sbf"]                           # (T, nb)
            contrib = torch.einsum("td,dbf,tb->tf", mk, bp["w_bilinear"],
                                   basis)
            contrib = torch.where(tm[:, None], contrib, 0.0)
            t_agg = ops.segment_sum_csr(contrib, *tri_csr)      # (E, d)
            m = m + _apply_mlp(bp["update"], t_agg, 2)
        # edge -> node
        node_in = ops.segment_sum_csr((m * emask[:, None]).contiguous(),
                                      *node_csr)
        h = h + _apply_mlp(bp["out_node"], node_in, 2)
        h = h * node_mask[:, None]
    return h @ params["head"]


# ---------------------------------------------------------------------------
# distributed (ring) path: the node ring for edge endpoints and the
# line-graph ring for triplets. Edges live with their destination node's
# owner, so the edge -> node sum is local.
# ---------------------------------------------------------------------------

def build_triplet_ring(g, n_shards: int, cap_per_edge: int = 8,
                       t_cap: Optional[int] = None):
    """Host prep for the line-graph ring: ``(ring, t_src, t_dst, t_mask)``,
    the triplet arrays (S, S, T_cap) of *local* edge slots (r·E_cap + k),
    grouped by the round of the source edge's owner, each group in the
    reference's order (edge instances shard by shard in slot order, and
    each edge's first ``cap_per_edge`` in-edges of its source node in that
    order, skipping k = i). On ``g``'s device."""
    ring = to_ring(g, n_shards)
    s_, r_, e_cap = ring.esrc_local.shape
    n_loc = g.n_nodes // n_shards
    esrc = ring.esrc_local.cpu().numpy().reshape(s_, -1).astype(np.int64)
    edst = ring.edst_local.cpu().numpy().reshape(s_, -1).astype(np.int64)
    shard, slot = np.nonzero(ring.edge_mask.cpu().numpy().reshape(s_, -1))
    gsrc = (shard - slot // e_cap) % n_shards * n_loc + esrc[shard, slot]
    gdst = shard * n_loc + edst[shard, slot]
    ts, td, tm = build_triplets_np(gsrc, gdst, np.ones(gsrc.size, bool),
                                   cap_per_edge)
    kj, ji = ts[tm].astype(np.int64), td[tm].astype(np.int64)
    key = shard[ji] * n_shards + (shard[ji] - shard[kj]) % n_shards
    counts = np.bincount(key, minlength=n_shards * n_shards)
    cap = t_cap or max(1, int(counts.max()))
    order = np.argsort(key, kind="stable")
    pos = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    keep = pos < cap
    idx, k, p = order[keep], key[order][keep], pos[keep]
    out = []
    for vals, dt in ((slot[kj], np.int32), (slot[ji], np.int32),
                     (np.ones(kj.size, bool), bool)):
        a = np.zeros((n_shards * n_shards, cap), dt)
        a[k, p] = vals[idx]
        out.append(torch.from_numpy(a.reshape(n_shards, n_shards, cap)).to(
            g.feats.device))
    return (ring, *out)


def ring_loss(cfg, params, ring, t_src, t_dst, t_mask, mesh, ce_sums_fn):
    """Distributed full-graph loss for DimeNet (see ``node_logits_ring``):
    ``ce_sums_fn(logits, labels, node_mask)`` over every shard's nodes, run
    as the reference's ``shard_map``: once per shard on its node blocks,
    with both engines per shard (``common.run_shards``). ``t_src`` None: no
    triplet interaction (as ``node_logits`` without triplets)."""
    s_, r_, e_cap = ring.esrc_local.shape
    ex_nodes = RingExec(ring.esrc_local, ring.edst_local, ring.edge_mask,
                        ring.feats.shape[0] // s_, mesh, split_model=False)
    ex_tri = None if t_src is None else RingExec(t_src, t_dst, t_mask,
                                                 r_ * e_cap, mesh)

    def body(ctx, p, feats, pos, nmask, labels):
        logits = node_logits_ring(
            cfg, p, feats, pos, nmask, ex_nodes.shard(ctx),
            None if ex_tri is None else ex_tri.shard(ctx))
        return ce_sums_fn(logits, labels, nmask)

    return run_shards(mesh, params, (ring.feats, ring.positions,
                                     ring.node_mask, ring.labels), body)


def _triplet_msg(cfg, bp):
    """One block's message of a triplet (kj -> ji) from the payload rows
    ``[m, rel, dist]`` of its two edges."""
    d = cfg.d_hidden

    def t_msg(srcs, dsts):
        m_kj = srcs[:, :d]
        rel_kj = srcs[:, d:d + 3]
        dist_kj = srcs[:, d + 3]
        rel_ji = dsts[:, d:d + 3]
        cos_a = torch.sum(-rel_kj * rel_ji, -1) / torch.clamp(
            torch.linalg.vector_norm(rel_kj, dim=-1)
            * torch.linalg.vector_norm(rel_ji, dim=-1), min=1e-9)
        angle = torch.arccos(torch.clamp(cos_a, -1 + 1e-7, 1 - 1e-7))
        sbf_r = spherical_bessel_basis(dist_kj, cfg.n_spherical,
                                       cfg.n_radial, cfg.cutoff)
        cbf = angular_basis(angle, cfg.n_spherical)
        sbf = (sbf_r * cbf[..., None]).reshape(srcs.shape[0], -1)
        mk = m_kj @ bp["w_msg"]
        basis = sbf @ bp["w_sbf"]
        return torch.einsum("td,dbf,tb->tf", mk, bp["w_bilinear"], basis)

    return t_msg


def node_logits_ring(cfg, params, feats, positions, node_mask, ex_nodes,
                     ex_tri):
    """(n_loc, n_out) logits of one shard over the ring (inside ``spmd``).
    feats, positions, node_mask: the shard's node blocks; ``ex_nodes`` /
    ``ex_tri``: its engines (``common.RingShard``). Edge tensors are the shard's node-ring slots
    (R·E_cap), which are also the line-graph ring's entities."""
    n = feats.shape[0]
    h = feats @ params["enc"]
    pos_src = ex_nodes.gather_src(positions)                   # (E_loc, 3)
    edst, emask = ex_nodes.dst_index()
    rel = pos_src - positions.index_select(0, edst)
    dist = torch.where(emask, torch.linalg.vector_norm(rel, dim=-1), 0.0)
    rbf_d = (radial_bessel_basis(dist, cfg.n_radial, cfg.cutoff)
             @ params["rbf_lin"])
    h_src = ex_nodes.gather_src(h)
    m = _apply_mlp(params["edge_embed"],
                   torch.cat([h_src, gather_rows(h, edst), rbf_d], -1), 2)
    m = m * emask[:, None]
    node_csr = csr_from_ids(torch.where(emask, edst, -1), n)
    for bp in params["blocks"]:
        if ex_tri is not None:
            payload = torch.cat([m, rel, dist[:, None]], -1)
            t_agg = ex_tri.push(payload, _triplet_msg(cfg, bp),
                                cfg.d_hidden)
            m = m + _apply_mlp(bp["update"], t_agg, 2) * emask[:, None]
        node_in = ops.segment_sum_csr((m * emask[:, None]).contiguous(),
                                      *node_csr)
        h = h + _apply_mlp(bp["out_node"], node_in, 2)
        h = h * node_mask[:, None]
    return h @ params["head"]
