"""EquiformerV2 — SO(2)-eSCN equivariant graph attention (Liao et al.,
arXiv:2306.12059), the port of ``repro.models.gnn.equiformer_v2``.

The eSCN trick: rotate each edge's source features into the edge-aligned
frame (Wigner-D from the Ivanic–Ruedenberg recurrence), where an SO(3)
tensor-product convolution reduces to independent SO(2) mixes per azimuthal
order m — O(L³) instead of O(L⁶) — truncated at ``m_max``. Attention weights
come from the invariant (l=0) channel; messages are rotated back and
softmax-aggregated per destination.

Feature layout: (N, (l_max+1)², C). Parameters are the reference's dict:
``enc``, ``layers[i].{so2_m0, so2_m{m}_r, so2_m{m}_i, attn_q, attn_k,
attn_alpha, ffn0, ffn1, ln1, ln2}``, ``head``. Each layer's aggregation is
one ``LocalExec.push_attn`` of H · (l_max+1)² · C/H columns (6,272 at the
published config): the CUDA segment-sum kernel on the card; its softmax
denominators go through ``sparse/segment.segment_sum``. As in the
reference, the logits and the messages each build the edge message.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.common.params import Init, resolve_device
from repro_torch.equivariant.spherical import (rotation_to_align_z, sh_dim,
                                               wigner_d_from_rotation)


def _m_orders(l_max: int, m_max: int):
    """(l, m) component bookkeeping for the SO(2) mix: for each m ∈ [0, m_max],
    the list of l's with l ≥ m. Components with |m| > m_max are truncated."""
    return {m: [l for l in range(l_max + 1) if l >= m] for m in range(m_max + 1)}


def _comp_index(l: int, m: int) -> int:
    return l * l + (m + l)


def init(cfg, seed: int, d_feat_in: int, n_out: int, *, device=None):
    """Seeded random fp32 parameters on ``device`` (None = the CUDA device).
    The draws differ from the reference's for the same seed: parity goes
    through ``convert.gnn_params_from_jax``."""
    device = resolve_device(device, "equiformer_v2.init")
    c, lm, mm, nh = cfg.d_hidden, cfg.l_max, cfg.m_max, cfg.n_heads
    dh = c // nh
    init = Init(seed, device, torch.float32)
    params = {"enc": init.dense((d_feat_in, c), fan_in=d_feat_in)}
    layers = []
    for _ in range(cfg.n_layers):
        lp = {}
        # SO(2) mixes: m=0 real mix; m>0 paired (cos/sin) complex-style mix
        for m, ls in _m_orders(lm, mm).items():
            k = len(ls) * c
            if m == 0:
                lp["so2_m0"] = init.dense((k, k), fan_in=k)
            else:
                lp[f"so2_m{m}_r"] = init.dense((k, k), fan_in=k)
                lp[f"so2_m{m}_i"] = init.dense((k, k), fan_in=k)
        lp["attn_q"] = init.dense((c, nh * dh), fan_in=c)
        lp["attn_k"] = init.dense((c, nh * dh), fan_in=c)
        lp["attn_alpha"] = init.dense((dh, 1), fan_in=dh)
        lp["ffn0"] = init.dense((c, 2 * c), fan_in=c)
        lp["ffn1"] = init.dense((2 * c, c), fan_in=2 * c)
        lp["ln1"] = init.ones((c,))
        lp["ln2"] = init.ones((c,))
        layers.append(lp)
    params["layers"] = layers
    params["head"] = init.dense((c, n_out), fan_in=c)
    return params


def edge_bytes(cfg) -> int:
    """fp32 temporaries of one edge in an edge message
    (``LocalExec.sized``): about ten (dim, C) tensors (the two payload
    rows, the rotated, mixed and rotated-back features, their gathered
    SO(2) blocks, the masked and permuted message)."""
    return 4 * 10 * sh_dim(cfg.l_max) * cfg.d_hidden


def engine(cfg, ex):
    """``ex`` sized for this model's widths (``LocalExec.sized``): the
    engine ``apply`` runs on."""
    return ex.sized(edge_bytes(cfg), 4 * sh_dim(cfg.l_max) * cfg.d_hidden)


@functools.lru_cache(maxsize=None)
def _rows(l_max: int, m_max: int, device: str):
    """Per m: the component rows of +m (and -m) over the l's of the mix."""
    out = {}
    for m, ls in _m_orders(l_max, m_max).items():
        out[m] = tuple(torch.tensor([_comp_index(l, s * m) for l in ls],
                                    device=device) for s in (1, -1))
    return out


def _so2_conv(lp, f_rot, orders, lm, c):
    """f_rot: (E, dim, C) in the edge frame. Mix channels×l per m; truncate
    |m| > m_max (their components stay zero — the eSCN truncation)."""
    e = f_rot.shape[0]
    rows = _rows(lm, max(orders), str(f_rot.device))
    out = torch.zeros_like(f_rot)
    for m, ls in orders.items():
        rp, rm = rows[m]
        fp = f_rot.index_select(1, rp).reshape(e, -1)
        if m == 0:
            mixed = fp @ lp["so2_m0"]
            out = out.index_copy(1, rp, mixed.reshape(e, len(ls), c))
        else:
            fm = f_rot.index_select(1, rm).reshape(e, -1)
            wr, wi = lp[f"so2_m{m}_r"], lp[f"so2_m{m}_i"]
            op = fp @ wr - fm @ wi
            om = fp @ wi + fm @ wr
            out = out.index_copy(1, rp, op.reshape(e, len(ls), c))
            out = out.index_copy(1, rm, om.reshape(e, len(ls), c))
    return out


def _rotate(f, Ds, lm, inverse=False):
    """Apply block-diagonal Wigner-D: f (E, dim, C)."""
    out = []
    for l in range(lm + 1):
        blk = f[:, l * l:(l + 1) * (l + 1), :]
        D = Ds[l]
        if inverse:
            D = D.transpose(-1, -2)
        out.append(torch.bmm(D, blk))
    return torch.cat(out, 1)


def message_fns(cfg, lp):
    """One layer's (logit_fn, msg_fn) for ``LocalExec.push_attn`` over the
    payload ``[h (dim·C), x (3)]``: both build the edge message (rotate
    into the edge frame, SO(2) mix, rotate back, 0 on zero-length edges);
    the logits come from its invariant channel and the destination's, the
    messages are its heads. A factory, so that a checkpointed block's
    recompute in the backward runs this layer's functions."""
    c, lm, nh = cfg.d_hidden, cfg.l_max, cfg.n_heads
    dh = c // nh
    dim = sh_dim(lm)
    orders = _m_orders(lm, cfg.m_max)

    def edge_message(srcs, dsts):
        e = srcs.shape[0]
        f_src = srcs[:, : dim * c].reshape(e, dim, c)
        rel = dsts[:, dim * c:] - srcs[:, dim * c:]
        R = rotation_to_align_z(rel)
        Ds = wigner_d_from_rotation(R.detach(), lm)
        f_rot = _rotate(f_src, Ds, lm)
        f_mix = _so2_conv(lp, f_rot, orders, lm, c)
        f_out = _rotate(f_mix, Ds, lm, inverse=True)
        # zero-length edges carry no frame: mask to preserve equivariance
        live = (torch.linalg.vector_norm(rel, dim=-1) > 1e-6).to(f_out.dtype)
        return f_out * live[:, None, None]

    def logit_fn(srcs, dsts):
        s_msg = edge_message(srcs, dsts)[:, 0, :]             # invariant channel
        s_dst = dsts[:, : dim * c].reshape(-1, dim, c)[:, 0, :]
        q = (s_dst @ lp["attn_q"]).reshape(-1, nh, dh)
        k = (s_msg @ lp["attn_k"]).reshape(-1, nh, dh)
        a = F.leaky_relu(q + k, 0.2)
        return (a @ lp["attn_alpha"])[..., 0]                 # (E, nh)

    def msg_fn(srcs, dsts):
        f_out = edge_message(srcs, dsts)
        e = f_out.shape[0]
        return f_out.reshape(e, dim, nh, dh).permute(0, 2, 1, 3).reshape(
            e, nh, dim * dh)

    return logit_fn, msg_fn


def apply(cfg, params, feats, positions, node_mask, ex):
    """Returns invariant node scalars (N, C)."""
    c, lm, nh = cfg.d_hidden, cfg.l_max, cfg.n_heads
    dh = c // nh
    dim = sh_dim(lm)
    n = feats.shape[0]
    ex = engine(cfg, ex)

    s0 = feats @ params["enc"]
    h = torch.cat([s0[:, None, :], s0.new_zeros((n, dim - 1, c))], 1)

    def eq_norm(f, scale):
        """Equivariant layernorm: per-l RMS over (m, c)."""
        outs = []
        for l in range(lm + 1):
            blk = f[:, l * l:(l + 1) * (l + 1), :]
            rms = torch.sqrt(torch.mean(torch.sum(blk * blk, 1), -1) + 1e-6)
            outs.append(blk / rms[:, None, None])
        return torch.cat(outs, 1) * scale[None, None, :]

    for lp in params["layers"]:
        payload = torch.cat([h.reshape(n, dim * c), positions], -1)
        agg = ex.push_attn(payload, *message_fns(cfg, lp), nh * dim * dh)
        agg = agg.reshape(n, nh, dim, dh).permute(0, 2, 1, 3).reshape(n, dim, c)
        h = h + agg

        # equivariant layernorm + scalar FFN
        h = eq_norm(h, lp["ln1"])
        s = h[:, 0, :]
        s = s + (F.silu(s @ lp["ffn0"]) @ lp["ffn1"])
        h = torch.cat([s[:, None, :], h[:, 1:, :]], 1)
        h = eq_norm(h, lp["ln2"]) * node_mask[:, None, None]
    return h[:, 0, :]


def node_logits(cfg, params, feats, positions, node_mask, ex,
                triplets=None):
    """(N, n_out) logits; ``triplets`` is DimeNet's alone (unused)."""
    return apply(cfg, params, feats, positions, node_mask, ex) @ params["head"]
