"""NequIP — E(3)-equivariant interatomic potential (Batzner et al.,
arXiv:2101.03164), the port of ``repro.models.gnn.nequip``: messages are
Clebsch–Gordan tensor products of neighbour features with edge spherical
harmonics, radially gated by learned R(r) weights.

Feature layout: per-l blocks with equal multiplicity C = cfg.d_hidden, flat
(N, C, Σ_l (2l+1)); block l occupies columns [l², (l+1)²).

Parameters are the reference's dict: ``enc``, ``layers[i].{r_w0, r_b0,
r_w1, self_l{l}, skip_l{l}, gate}``, ``head``. Each layer's aggregation is
one ``LocalExec.push`` of C·(l_max+1)² + 1 columns (289 at the published
config): the CUDA segment-sum kernel on the card.

The reference adds each path's einsum into its output slice, one path at
a time. The port computes the same sums with three products over all
paths at once: per edge the matrix M (dim, S) = Σ_b sh_b · CG[b] that maps
the source features to every path's output components (S = Σ_paths
(2 l3 + 1), grouped by l3), a batched product h_src (C, dim) @ M, and per
l3 the paths' outputs times their radial weights, summed over the paths.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.params import Init, resolve_device
from repro_torch.equivariant.bessel import envelope
from repro_torch.equivariant.cg import clebsch_gordan
from repro_torch.equivariant.spherical import real_sph_harm, sh_dim


def _paths(l_max: int) -> List[Tuple[int, int, int]]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def _slice(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def init(cfg, seed: int, d_feat_in: int, n_out: int, *, device=None):
    """Seeded random fp32 parameters on ``device`` (None = the CUDA device).
    The draws differ from the reference's for the same seed: parity goes
    through ``convert.gnn_params_from_jax``."""
    device = resolve_device(device, "nequip.init")
    c, lm = cfg.d_hidden, cfg.l_max
    n_paths = len(_paths(lm))
    init = Init(seed, device, torch.float32)
    params = {"enc": init.dense((d_feat_in, c), fan_in=d_feat_in)}
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"r_w0": init.dense((cfg.n_rbf, 32), fan_in=cfg.n_rbf),
              "r_b0": init.zeros((32,)),
              "r_w1": init.dense((32, n_paths * c), fan_in=32)}
        for l in range(lm + 1):
            lp[f"self_l{l}"] = init.dense((c, c), fan_in=c)
            lp[f"skip_l{l}"] = init.dense((c, c), fan_in=c)
        lp["gate"] = init.dense((c, lm * c), fan_in=c)
        layers.append(lp)
    params["layers"] = layers
    params["head"] = init.dense((c, n_out), fan_in=c)
    return params


def edge_bytes(cfg) -> int:
    """fp32 temporaries of one edge in ``msg_fn`` (``LocalExec.sized``):
    the two payload rows, M, the path outputs twice, the radial weights,
    the output twice."""
    c, dim, lm = cfg.d_hidden, sh_dim(cfg.l_max), cfg.l_max
    s = sum(2 * l3 + 1 for _, _, l3 in _paths(lm))
    return 4 * (2 * (c * dim + 3) + dim * s + 2 * c * s
                + len(_paths(lm)) * c + 2 * c * dim)


def engine(cfg, ex):
    """``ex`` sized for this model's widths (``LocalExec.sized``): the
    engine ``apply`` runs on."""
    return ex.sized(edge_bytes(cfg),
                    4 * (cfg.d_hidden * sh_dim(cfg.l_max) + 1))


@functools.lru_cache(maxsize=None)
def _tp_tables_np(l_max: int):
    """(cg (dim, dim·S) float32, path order by l3, [(l3, first path, last
    path, first column, last column)]): ``cg[b, a·S + s]`` is
    CG_p[m3, a, b] for the output component s = (path p, m3), the paths
    in order of l3 (stable), each l1/l2 block at its slice."""
    dim = sh_dim(l_max)
    paths = _paths(l_max)
    order = sorted(range(len(paths)), key=lambda p: paths[p][2])
    s_total = sum(2 * l3 + 1 for _, _, l3 in paths)
    cg = np.zeros((dim, dim, s_total), np.float32)   # (b, a, s)
    groups, col = [], 0
    for l3 in range(l_max + 1):
        first_p = sum(1 for p in order if paths[p][2] < l3)
        first_c = col
        for p in order:
            l1, l2, pl3 = paths[p]
            if pl3 != l3:
                continue
            c = clebsch_gordan(l1, l2, l3).astype(np.float32)  # (m, a, b)
            n3 = 2 * l3 + 1
            cg[_slice(l2), _slice(l1), col:col + n3] = np.transpose(c, (2, 1, 0))
            col += n3
        n_l3 = sum(1 for p in order if paths[p][2] == l3)
        groups.append((l3, first_p, first_p + n_l3, first_c, col))
    return cg.reshape(dim, dim * s_total), np.asarray(order), groups


@functools.lru_cache(maxsize=None)
def _tp_tables(l_max: int, device: str):
    cg, order, groups = _tp_tables_np(l_max)
    return (torch.as_tensor(cg, device=device),
            torch.as_tensor(order, device=device), groups)


def _rbf(dist, n_rbf: int, cutoff: float):
    mu = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    beta = (n_rbf / cutoff) ** 2
    return (torch.exp(-beta * (dist[..., None] - mu) ** 2)
            * envelope(dist, cutoff)[..., None])


def message_fn(cfg, lp):
    """One layer's msg_fn for ``LocalExec.push``: (src rows, dst rows) of
    the payload ``[h (C·dim), x (3)]`` -> ``[Σ_paths CG ⊗ (h_src, sh) ·
    R(r) / √P, 1]`` (C·dim + 1 columns), 0 on zero-length edges."""
    c, lm = cfg.d_hidden, cfg.l_max
    dim = sh_dim(lm)
    n_paths = len(_paths(lm))

    def msg_fn(srcs: torch.Tensor, dsts: torch.Tensor) -> torch.Tensor:
        e = srcs.shape[0]
        cg, order, groups = _tp_tables(lm, str(srcs.device))
        s_total = cg.shape[1] // dim
        h_src = srcs[:, : c * dim].reshape(e, c, dim)
        rel = dsts[:, c * dim:] - srcs[:, c * dim:]
        dist = torch.linalg.vector_norm(rel, dim=-1)
        sh = real_sph_harm(rel, lm)                          # (E, dim)
        rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff)              # (E, n_rbf)
        rw = F.silu(rbf @ lp["r_w0"] + lp["r_b0"]) @ lp["r_w1"]
        rw = rw.reshape(e, n_paths, c).index_select(1, order)  # by l3
        m = (sh @ cg).reshape(e, dim, s_total)               # (E, dim, S)
        t = torch.bmm(h_src, m)                              # (E, C, S)
        outs = []
        for l3, p0, p1, c0, c1 in groups:
            blk = t[:, :, c0:c1].reshape(e, c, p1 - p0, 2 * l3 + 1)
            w = rw[:, p0:p1, :].transpose(1, 2)[..., None]   # (E, C, P3, 1)
            outs.append((blk * w).sum(2))
        out = torch.cat(outs, -1) / math.sqrt(n_paths)       # (E, C, dim)
        # zero-length edges (self-loops / padding) carry no direction:
        # masking them preserves exact equivariance
        live = (dist > 1e-6).to(out.dtype)[:, None]
        ones = torch.ones((e, 1), dtype=out.dtype, device=out.device)
        return torch.cat([out.reshape(e, c * dim), ones], -1) * live

    return msg_fn


def apply(cfg, params, feats, positions, node_mask, ex):
    """Returns invariant node scalars (N, C) after cfg.n_layers interactions."""
    c, lm = cfg.d_hidden, cfg.l_max
    dim = sh_dim(lm)
    n = feats.shape[0]
    ex = engine(cfg, ex)
    s0 = feats @ params["enc"]                                # scalar init
    h = torch.cat([s0[:, :, None], s0.new_zeros((n, c, dim - 1))], -1)

    for lp in params["layers"]:
        payload = torch.cat([h.reshape(n, c * dim), positions], -1)
        agg_c = ex.push(payload, message_fn(cfg, lp), c * dim + 1)
        deg = torch.clamp(agg_c[:, -1:], min=1.0)              # (N, 1)
        agg = (agg_c[:, :-1] / torch.sqrt(deg)).reshape(n, c, dim)

        # self-interaction + gated nonlinearity, per l
        gates = torch.sigmoid(h[:, :, 0] @ lp["gate"]).reshape(n, lm, c)
        blocks = []
        for l in range(lm + 1):
            sl = _slice(l)
            mixed = torch.einsum("ncm,cd->ndm", agg[:, :, sl], lp[f"self_l{l}"])
            skip = torch.einsum("ncm,cd->ndm", h[:, :, sl], lp[f"skip_l{l}"])
            blk = mixed + skip
            if l == 0:
                blk = F.silu(blk)
            else:
                blk = blk * gates[:, l - 1][:, :, None]
            blocks.append(blk)
        h = torch.cat(blocks, -1) * node_mask[:, None, None]
    return h[:, :, 0]                                        # invariant scalars


def node_logits(cfg, params, feats, positions, node_mask, ex,
                triplets=None):
    """(N, n_out) logits; ``triplets`` is DimeNet's alone (unused)."""
    return apply(cfg, params, feats, positions, node_mask, ex) @ params["head"]
