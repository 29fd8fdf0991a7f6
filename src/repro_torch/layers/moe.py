"""Mixture-of-experts FFN: top-k routing with capacity-bounded dispatch, the
port of ``repro.layers.moe``.

Per call of t tokens, k choices and E experts:

- the router is an fp32 matmul (``wr`` is fp32 whatever the model dtype;
  the port leaves PyTorch's default of full fp32 matmuls, no TF32, in
  place: a TF32 router would flip choices at near-ties), softmax, top-k
  in ``jax.lax.top_k``'s order (``common/topk.py``) and gates
  renormalised over the k;
- each expert takes ``cap = max(ceil(t·k·cf / E), 1)`` assignments, ranked
  token-major then by choice (a cumsum over the (t·k, E) one-hot); the
  rest are dropped;
- the dispatch writes every (token, choice) row into an (E·cap + 1, D)
  buffer in one ``index_copy_``, the drops all onto the last row, which is
  then sliced off (no boolean filter, so no host sync): the kept slots are
  unique, so the result is deterministic on the card too;
- a grouped SwiGLU (E, cap, D) × (E, D, F) over every expert's buffer
  (``torch.bmm``), and the gated combine summed over the k choices;
- the Switch load-balance loss E · Σ_e f_e · P_e.

A token's output depends on the other tokens of its call when an expert
overflows: the reference's semantics, kept.

Over a mesh (``moe_ffn(mesh=)``, the reference's ``shard_map`` body run
on one controller through ``sharding/collectives.py``): the expert
weights are laid out (E, D, F) with D split over "data" (ZeRO-3) and F
over "model" (tensor parallel); each (data, model) shard all-gathers its
weights over "data", routes and dispatches its own data shard's tokens
at that shard's capacity ``ceil(T_loc·k·cf / E)`` (so a sharded call
drops other tokens than an unsharded one), runs its F slice, and the
outputs are ``psum``med over "model". The load-balance statistics are
``pmean``ed over the data axes. A batch that does not divide by the data
shards (batch 1 in decode) is replicated instead, each shard routing
every token.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.params import Init
from repro_torch.common.topk import top_k
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import data_axes, require_mesh


def init_moe(cfg, init: Init) -> Dict[str, torch.Tensor]:
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    return {"wr": init.dense((d, e), fan_in=d, dtype=torch.float32),
            "w1": init.dense((e, d, f), fan_in=d),
            "w3": init.dense((e, d, f), fan_in=d),
            "w2": init.dense((e, f, d), fan_in=f)}


class Routing(NamedTuple):
    """One call's routing of t tokens: ``probs`` (t, E) fp32, ``gate`` and
    ``idx`` (t, k) (renormalised gates, expert ids), and per (token,
    choice) in token-major order ``keep`` (t·k,) bool and ``slot`` (t·k,)
    int64, the row of the (E·cap + 1, D) dispatch buffer (E·cap for a
    drop); ``cap`` the per-expert capacity."""
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(cfg, p: Dict[str, torch.Tensor], xf: torch.Tensor,
          capacity_factor: float) -> Routing:
    """Routes xf (t, D): fp32 router, softmax, top-k, capacity ranking."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(math.ceil(t * k * capacity_factor / e)), 1)
    probs = torch.softmax(xf.to(torch.float32) @ p["wr"], dim=-1)    # (t, e)
    gate, idx = top_k(probs, k)                                      # (t, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    # place within each expert's buffer: token-major, then choice order
    eid = idx.reshape(t * k)
    oh = F.one_hot(eid, e).to(torch.int32)                           # (t·k, e)
    pos = ((torch.cumsum(oh, dim=0, dtype=torch.int32) - oh) * oh).sum(-1)
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos, e * cap)               # drops: last row
    return Routing(probs, gate, idx, keep, slot, cap)


def _dispatch_combine(cfg, p, x, w1, w3, w2, capacity_factor: float):
    """One shard's MoE body over its tokens x (B, S, D) and its expert
    weights (E, D, F'), (E, F', D): (out (B, S, D), frac (E,), mean probs
    (E,), routing)."""
    dtype = x.dtype
    bsz, s, d = x.shape
    t = bsz * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(t, d)
    r = route(cfg, p, xf, capacity_factor)
    cap = r.cap

    xrep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=x.device)
    buf.index_copy_(0, r.slot, xrep)
    xe = buf[: e * cap].view(e, cap, d)

    h = torch.bmm(xe, w1.to(dtype))
    u = torch.bmm(xe, w3.to(dtype))
    ye = torch.bmm(F.silu(h) * u, w2.to(dtype))                     # (e, cap, d)

    yflat = torch.cat([ye.reshape(e * cap, d),
                       torch.zeros((1, d), dtype=dtype, device=x.device)])
    w = (r.gate.reshape(t * k, 1) * r.keep[:, None]).to(dtype)
    out = (yflat[r.slot] * w).reshape(t, k, d).sum(dim=1)
    frac = F.one_hot(r.idx[:, 0], e).to(torch.float32).mean(dim=0)
    return out.reshape(bsz, s, d), frac, r.probs.mean(dim=0), r


def moe_ffn(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, mesh=None, *,
            capacity_factor: float = 1.25, routings: Optional[list] = None):
    """x (B, S, D) -> (out (B, S, D), aux ()). ``routings``: a list to
    which the call appends its ``Routing`` (device tensors: reading one is the
    caller's sync); over a mesh, one for each data shard in shard order
    (the first shard's alone when the batch is replicated)."""
    if mesh is None:
        out, frac, pm, r = _dispatch_combine(cfg, p, x, p["w1"], p["w3"],
                                             p["w2"], capacity_factor)
        if routings is not None:
            routings.append(r)
        # load-balance aux loss (Switch): E · Σ_e f_e · P_e
        return out, cfg.n_experts * torch.sum(frac * pm)
    require_mesh(mesh, "moe_ffn")
    # batch=1 decode cells can't shard tokens over data: replicate instead
    axes = data_axes(mesh, x.shape[0])
    xs = col.split(x, mesh, axes) if axes else col.replicate(x, mesh)

    def weights(name, spec, d_dim):
        ws = col.blocks(p[name], mesh, spec)
        if "data" in mesh.shape:             # ZeRO-3 weight gather
            ws = col.all_gather(ws, mesh, "data", dim=d_dim)
        return ws

    w1 = weights("w1", (None, "data", "model"), 1)
    w3 = weights("w3", (None, "data", "model"), 1)
    w2 = weights("w2", (None, "model", "data"), 2)
    res = col.map_shards(
        lambda _, xx, a, b, c: _dispatch_combine(cfg, p, xx, a, b, c,
                                                 capacity_factor),
        mesh, xs, w1, w3, w2)
    out = [o for o, _, _, _ in res]
    if "model" in mesh.shape:
        out = col.psum(out, mesh, "model")       # tensor-parallel reduce
    frac = [f for _, f, _, _ in res]
    pm = [m for _, _, m, _ in res]
    if axes:
        frac = col.pmean(frac, mesh, axes)
        pm = col.pmean(pm, mesh, axes)
    if routings is not None:
        routings.extend(col.firsts([r for _, _, _, r in res], mesh, axes))
    aux = cfg.n_experts * torch.sum(frac[0] * pm[0])
    return col.unsplit(out, mesh, axes), aux


def near_tie_gap(r: Routing) -> torch.Tensor:
    """The least k-th minus (k+1)-th router probability over a call's
    tokens (0-d; inf when k = E). Under ~1e-6 it is a near-tie that the
    router matmul summed in another order may flip."""
    k = r.idx.shape[1]
    if k == r.probs.shape[1]:
        return torch.full((), float("inf"), device=r.probs.device)
    top = top_k(r.probs, k + 1)[0]
    return (top[:, k - 1] - top[:, k]).min()
