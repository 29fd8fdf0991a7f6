"""xDeepFM (Lian et al., arXiv:1803.05170): linear + CIN + DNN over sparse
field embeddings (the port of ``repro.models.recsys.xdeepfm``).

CIN layer k:  X^k_{h} = Σ_{i,j} W^k_{h,i,j} (X^{k-1}_i ∘ X^0_j)

The reference writes it as one einsum, ``"bpd,bmd,hpm->bhd"``. Any order
of that contraction builds the outer product z (B, p·m, D): at the
published 39 fields, D 10 and 200 maps that is 312 KB a row, 20.4 GB
for a layer at the train batch of 65,536 and 81.8 GB at serve_bulk's
262,144. So ``cin`` runs in fixed chunks of ``CIN_CHUNK_ROWS`` rows.
Within a chunk the rows are laid out (b, D, fields): z is one
``(b·D, p·m)`` matrix and each layer one GEMM against ``W`` as a
``(p·m, H)`` matrix. 8,192 rows make a 2.56 GB z at 200 × 39 and about
8 GB of temporaries when a chunk's backward runs; 32 chunks cover
serve_bulk. Under grad each chunk is checkpointed
(``torch.utils.checkpoint``) and recomputed in the backward, so no
whole-batch z is held.

The GEMMs are fp32 at PyTorch's default of no TF32, as on every parity
path. Both table reads (the embeddings and the first-order ``linear_w``)
are ``embedding_bag.lookup``: one gather each, whose transpose under grad
is one launch of the in-place kernel. ``retrieval_score`` scores one
user against N candidates as one GEMV over the candidates' joint
embeddings. Over a mesh, the embeddings come from
``embedding_bag.lookup_sharded`` (the rest of the forward is unchanged,
as under GSPMD), and ``retrieval_score`` scores then reduces: each shard
scores its candidates (split over the data axes) from its own rows and
the partial scores are ``psum``med over "model".
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Init, resolve_device
from repro_torch.common.tree import leaves, tree_map
from repro_torch.models.recsys.embedding_bag import (init_tables,
                                                     local_rows, lookup,
                                                     lookup_sharded,
                                                     table_shards)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import data_axes
from repro_torch.train.optimizer import AdamWConfig, adamw_update

CIN_CHUNK_ROWS = 8192


def init(cfg, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """Seeded random fp32 parameters on ``device`` (None = the CUDA
    device), in the reference's layout. The draws differ from the
    reference's: parity goes through ``convert.recsys_params_from_jax``."""
    device = resolve_device(device, "xdeepfm.init")
    ini = Init(seed, device, torch.float32)
    params = init_tables(ini, cfg.n_sparse, cfg.vocab_per_field,
                         cfg.embed_dim)
    # first-order (linear) weights: one scalar per id
    params["linear_w"] = ini.dense((cfg.n_sparse, cfg.vocab_per_field),
                                   fan_in=cfg.vocab_per_field, scale=0.1)
    params["bias"] = ini.zeros((1,))
    m = prev = cfg.n_sparse
    for k, h in enumerate(cfg.cin_layers):
        params[f"cin_w{k}"] = ini.dense((h, prev, m), fan_in=prev * m)
        prev = h
    params["cin_out"] = ini.dense((sum(cfg.cin_layers), 1),
                                  fan_in=sum(cfg.cin_layers))
    d_in = cfg.n_sparse * cfg.embed_dim
    for k, h in enumerate(cfg.mlp_layers):
        params[f"mlp_w{k}"] = ini.dense((d_in, h), fan_in=d_in)
        params[f"mlp_b{k}"] = ini.zeros((h,))
        d_in = h
    params["mlp_out"] = ini.dense((d_in, 1), fan_in=d_in)
    return params


def _cin_rows(x0t: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    """The CIN over a chunk of rows laid out (b, D, m): (b, ΣH)."""
    b, d, m = x0t.shape
    xk, pooled = x0t, []
    for w in ws:
        h, p, _ = w.shape
        z = (xk[:, :, :, None] * x0t[:, :, None, :]).reshape(b * d, p * m)
        xk = (z @ w.reshape(h, p * m).t()).reshape(b, d, h)
        pooled.append(xk.sum(1))
    return torch.cat(pooled, dim=-1)


def cin(params, x0: torch.Tensor, n_layers: int) -> torch.Tensor:
    """x0: (B, m, D). Returns (B, ΣH) pooled CIN features, computed
    ``CIN_CHUNK_ROWS`` rows at a time (checkpointed under grad)."""
    ws = [params[f"cin_w{k}"] for k in range(n_layers)]
    x0t = x0.transpose(1, 2).contiguous()
    grad = torch.is_grad_enabled() and (
        x0t.requires_grad or any(w.requires_grad for w in ws))
    out = []
    for a in range(0, x0t.shape[0], CIN_CHUNK_ROWS):
        part = x0t[a:a + CIN_CHUNK_ROWS]
        out.append(checkpoint(_cin_rows, part, *ws, use_reentrant=False)
                   if grad else _cin_rows(part, *ws))
    return out[0] if len(out) == 1 else torch.cat(out)


def forward(cfg, params, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """ids (B, F) int -> logits (B,)."""
    if mesh is not None:
        emb = lookup_sharded(params["tables"], ids, mesh)    # (B, F, D)
    else:
        emb = lookup(params["tables"], ids)
    bsz = ids.shape[0]
    # first order
    first = lookup(params["linear_w"][..., None], ids)[..., 0].sum(-1)
    cin_feat = cin(params, emb, len(cfg.cin_layers))         # (B, ΣH)
    cin_logit = (cin_feat @ params["cin_out"])[:, 0]
    h = emb.reshape(bsz, -1)
    for k in range(len(cfg.mlp_layers)):
        h = torch.relu(h @ params[f"mlp_w{k}"] + params[f"mlp_b{k}"])
    mlp_logit = (h @ params["mlp_out"])[:, 0]
    return first + cin_logit + mlp_logit + params["bias"][0]


def loss_fn(cfg, params, batch, mesh=None):
    """(mean BCE with logits, {"acc"}) over ``batch["ids"]`` and
    ``batch["labels"]``."""
    logits = forward(cfg, params, batch["ids"], mesh)
    y = batch["labels"].to(torch.float32)
    # numerically-stable BCE with logits
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"acc": acc}


def make_train_step(cfg, opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3)):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    (the reference launcher's ``_step``): the loss's gradient, then AdamW
    into new trees. Metrics: ``loss``, ``acc``, ``grad_norm``, ``lr``."""

    def step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss, aux = loss_fn(cfg, live, batch)
            got = iter(torch.autograd.grad(loss, leaves(live)))
        grads = tree_map(lambda _: next(got), params)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, {"loss": loss.detach(),
                                   "acc": aux["acc"], **om}

    return step


def retrieval_score(cfg, params, user_ids: torch.Tensor,
                    cand_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """One query against N candidates (a batched dot, not a loop).

    user_ids (F,) — the user's feature ids; cand_ids (N, F) — candidate
    item feature ids. Score = <pooled user embedding, pooled item
    embedding>: (N,). Over a mesh the candidates split over the data axes
    and each shard's partial scores (from the table rows it holds) are
    ``psum``med over "model" (the module docstring)."""
    if mesh is None:
        u = lookup(params["tables"], user_ids[None, :])[0]   # (F, D)
        c = lookup(params["tables"], cand_ids)               # (N, F, D)
        return c.reshape(c.shape[0], -1) @ u.reshape(-1)
    u = lookup_sharded(params["tables"], user_ids[None, :], mesh)[0]
    tabs, v_loc = table_shards(params["tables"], mesh)
    axes = data_axes(mesh, cand_ids.shape[0])
    cands = (col.split(cand_ids, mesh, axes) if axes
             else col.replicate(cand_ids, mesh))

    def score(sh, t, c, uu):
        rows = local_rows(sh, t, c, v_loc)                   # (B_loc, F, D)
        return rows.reshape(rows.shape[0], -1) @ uu.reshape(-1)

    part = col.map_shards(score, mesh, tabs, cands, col.replicate(u, mesh))
    if "model" in mesh.shape:
        part = col.psum(part, mesh, "model")
    return col.unsplit(part, mesh, axes)
