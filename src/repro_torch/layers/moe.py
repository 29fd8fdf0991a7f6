"""Mixture-of-experts FFN: top-k routing with capacity-bounded dispatch, the
port of ``repro.layers.moe`` (its unsharded path, ``mesh=None``).

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
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.params import Init
from repro_torch.common.topk import top_k


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


def moe_ffn(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, mesh=None, *,
            capacity_factor: float = 1.25, routings: Optional[list] = None):
    """x (B, S, D) -> (out (B, S, D), aux ()). ``routings``: a list to
    which the call appends its ``Routing`` (device tensors: reading one is the
    caller's sync)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn over a mesh is not ported to repro_torch (ROADMAP.md "
            "Queue 1 item 15: a multi-process torch.distributed design)")
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

    h = torch.bmm(xe, p["w1"].to(dtype))
    u = torch.bmm(xe, p["w3"].to(dtype))
    ye = torch.bmm(F.silu(h) * u, p["w2"].to(dtype))                 # (e, cap, d)

    yflat = torch.cat([ye.reshape(e * cap, d),
                       torch.zeros((1, d), dtype=dtype, device=x.device)])
    w = (r.gate.reshape(t * k, 1) * r.keep[:, None]).to(dtype)
    out = (yflat[r.slot] * w).reshape(t, k, d).sum(dim=1)

    # load-balance aux loss (Switch): E · Σ_e f_e · P_e
    frac = F.one_hot(r.idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(frac * r.probs.mean(dim=0))
    if routings is not None:
        routings.append(r)
    return out.reshape(bsz, s, d), aux


def near_tie_gap(r: Routing) -> torch.Tensor:
    """The least k-th minus (k+1)-th router probability over a call's
    tokens (0-d; inf when k = E). Under ~1e-6 it is a near-tie that the
    router matmul summed in another order may flip."""
    k = r.idx.shape[1]
    if k == r.probs.shape[1]:
        return torch.full((), float("inf"), device=r.probs.device)
    top = top_k(r.probs, k + 1)[0]
    return (top[:, k - 1] - top[:, k]).min()
