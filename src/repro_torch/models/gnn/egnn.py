"""EGNN — E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844), the
port of ``repro.models.gnn.egnn``.

    m_ij   = φ_e(h_i, h_j, ‖x_i − x_j‖²)
    x_i'   = x_i + C·Σ_j (x_i − x_j)·φ_x(m_ij)
    h_i'   = φ_h(h_i, Σ_j m_ij)

Parameters are a plain dict in the reference's layout: ``enc``,
``layers[i].{phi_e, phi_x, phi_h}.{w0, b0, w1, b1}``, ``head``.
Each layer's aggregation is one ``LocalExec.push``: the CUDA segment-sum
kernel on the card.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.common.params import Init, resolve_device


def _init_mlp(init: Init, dims: Sequence[int]) -> Dict[str, torch.Tensor]:
    p = {}
    for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = init.dense((di, do), fan_in=di)
        p[f"b{i}"] = init.zeros((do,))
    return p


def _apply_mlp(p, x: torch.Tensor, n_layers: int, final_act: bool = False):
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1 or final_act:
            x = F.silu(x)
    return x


def init(cfg, seed: int, d_feat_in: int, n_out: int, *, device=None):
    """Seeded random fp32 parameters on ``device`` (None = the CUDA device).
    The draws differ from the reference's for the same seed: parity goes
    through ``convert.gnn_params_from_jax``."""
    device = resolve_device(device, "egnn.init")
    d = cfg.d_hidden
    init = Init(seed, device, torch.float32)
    params = {"enc": init.dense((d_feat_in, d), fan_in=d_feat_in)}
    params["layers"] = [{"phi_e": _init_mlp(init, (2 * d + 1, d, d)),
                         "phi_x": _init_mlp(init, (d, d, 1)),
                         "phi_h": _init_mlp(init, (2 * d, d, d))}
                        for _ in range(cfg.n_layers)]
    params["head"] = init.dense((d, n_out), fan_in=d)
    return params


def message_fn(cfg, lp):
    """One layer's msg_fn for ``LocalExec.push``: (src rows, dst rows) of
    the payload ``[h, x]`` -> ``[m_ij, (x_i − x_j)·tanh(φ_x(m_ij)), 1]``
    (d + 3 + 1 columns; i = destination)."""
    d = cfg.d_hidden

    def msg_fn(srcs: torch.Tensor, dsts: torch.Tensor) -> torch.Tensor:
        hs, xs = srcs[:, :d], srcs[:, d:]
        hd, xd = dsts[:, :d], dsts[:, d:]
        rel = xd - xs
        r2 = (rel * rel).sum(-1, keepdim=True)
        m = _apply_mlp(lp["phi_e"], torch.cat([hd, hs, r2], -1), 2,
                       final_act=True)                      # (E, d)
        cw = torch.tanh(_apply_mlp(lp["phi_x"], m, 2))      # (E, 1) bounded
        return torch.cat([m, rel * cw, torch.ones_like(cw)], -1)

    return msg_fn


def apply(cfg, params, feats, positions, node_mask, ex):
    """Returns (node_embeddings (N, d), new_positions)."""
    d = cfg.d_hidden
    h = feats @ params["enc"]
    x = positions
    for lp in params["layers"]:
        payload = torch.cat([h, x], -1)                     # (N, d+3)
        agg = ex.push(payload, message_fn(cfg, lp), d + 3 + 1)
        m_sum, x_upd, cnt = agg[:, :d], agg[:, d:d + 3], agg[:, d + 3:]
        h = h + _apply_mlp(lp["phi_h"], torch.cat([h, m_sum], -1), 2)
        x = x + x_upd / torch.clamp(cnt, min=1.0)
        h = h * node_mask[:, None]
    return h, x


def engine(cfg, ex):
    """The engine ``apply`` runs on: ``ex`` as it is (EGNN's widths are
    the ones ``LocalExec``'s defaults were set for)."""
    return ex


def node_logits(cfg, params, feats, positions, node_mask, ex,
                triplets=None):
    """(N, n_out) logits; ``triplets`` is DimeNet's alone (unused)."""
    h, _ = apply(cfg, params, feats, positions, node_mask, ex)
    return h @ params["head"]
