"""The RAG engine's transformer LM, serving half: init, prefill with
KV-cache production, one-token decode with per-slot positions, and an
inference ``forward`` (the port of ``repro.models.lm``).

Every LM config of the reference: GQA or multi-head latent attention
(``layers/mla.py``), dense or mixture-of-experts FFN (``layers/moe.py``,
with shared experts and dense first layers), QKV bias, a sliding window,
tied or untied embeddings. The reference's ``lax.scan`` over stacked
layers is a Python loop over per-layer parameters here. Training
(``xent_loss``, ``loss_fn``, ``make_train_step`` and the bf16 gradient
barrier) is not ported yet.

Parameters are a dict: ``embed`` (V, D), ``final_ln`` (D,), ``head``
(D, V) when embeddings are untied, and ``layers``, a list of per-layer
dicts ``{"attn": {...}, "ln1", "ln2", "ffn": {w1, w3, w2}}`` — a MoE
layer has ``"moe": {wr, w1, w3, w2}`` and, with shared experts,
``"shared": {w1, w3, w2}`` in place of ``"ffn"``. ``attn`` is
``{wq, wk, wv, wo[, bq, bk, bv]}`` (GQA) or ``{wq, w_dkv, w_krope, w_uk,
w_uv, wo}`` (MLA). The cache is a tuple of three tensors with a leading L
axis, laid out as in the reference: (L, B, clen, Hkv, hd) K and V (GQA)
or (L, B, clen, r) latents and (L, B, clen, dr) roped keys (MLA), then
an (L, B, clen) int32 tensor of the position held in each slot (-10^9
when empty).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.params import Init, dtype_of, resolve_device
from repro_torch.layers.attention import gqa_forward, init_gqa
from repro_torch.layers.mla import init_mla, mla_forward
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.norms import rms_norm

Cache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
EMPTY_SLOT = -(10 ** 9)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg, init: Init, layer_idx: int) -> Dict[str, object]:
    lp: Dict[str, object] = {
        "attn": (init_mla if cfg.attention == "mla" else init_gqa)(cfg, init),
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,))}
    if cfg.moe and layer_idx >= cfg.first_dense_layers:
        lp["moe"] = init_moe(cfg, init)
        if cfg.n_shared_experts:
            lp["shared"] = init_swiglu(
                cfg, init, d_ff=cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff))
    else:
        lp["ffn"] = init_swiglu(
            cfg, init, d_ff=(cfg.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff)
    return lp


def init_lm(cfg, seed: int = 0, *, device=None) -> Dict[str, object]:
    """Seeded random parameters in ``cfg.dtype``, made on ``device`` (None =
    the CUDA device; raises without one). The draws differ from the
    reference's ``init_lm`` for the same seed."""
    device = resolve_device(device, "init_lm")
    init = Init(seed, device, dtype_of(cfg.dtype))
    params: Dict[str, object] = {
        "embed": init.dense((cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = init.dense((cfg.d_model, cfg.vocab_size),
                                    fan_in=cfg.d_model)
    params["final_ln"] = init.ones((cfg.d_model,))
    params["layers"] = [_init_layer(cfg, init, i) for i in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, lp, x, positions, mode, cache_l, cache_pos, moe_routings):
    """One block; returns (x, this layer's cache, MoE aux loss)."""
    attn = mla_forward if cfg.attention == "mla" else gqa_forward
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, new_cache = attn(cfg, lp["attn"], h, positions, mode=mode,
                        cache=cache_l, cache_pos=cache_pos)
    x = x + h
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        out, aux = moe_ffn(cfg, lp["moe"], hn,
                           capacity_factor=cfg.capacity_factor,
                           routings=moe_routings)
        if "shared" in lp:
            out = out + swiglu(lp["shared"], hn)
    else:
        out, aux = swiglu(lp["ffn"], hn), None
    return x + out, new_cache, aux


def _logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["head"].to(x.dtype)


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype_of(cfg.dtype))


def forward(cfg, params, tokens: torch.Tensor, *,
            moe_routings: Optional[list] = None):
    """Inference forward: tokens (B, S) -> (logits (B, S, V), aux), aux the
    MoE load-balance loss summed over the layers (fp32; 0 for a dense
    model). No cache is kept and nothing is differentiated."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, _, a = _layer_fwd(cfg, lp, x, positions, "full", None, None,
                             moe_routings)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_len_for(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg, batch: int, cache_len: int, *, device=None) -> Cache:
    """An empty cache (zeros, every slot position -10^9) with a leading L
    axis: K/V for GQA, (latent, roped k) for MLA. device: None = the CUDA
    device."""
    device = resolve_device(device, "init_cache")
    dt = dtype_of(cfg.dtype)
    L = cfg.n_layers
    if cfg.attention == "mla":
        shapes = [(L, batch, cache_len, cfg.kv_lora_rank),
                  (L, batch, cache_len, cfg.qk_rope_head_dim)]
    else:
        shapes = [(L, batch, cache_len, cfg.n_kv_heads,
                   cfg.resolved_head_dim)] * 2
    return (torch.zeros(shapes[0], dtype=dt, device=device),
            torch.zeros(shapes[1], dtype=dt, device=device),
            torch.full((L, batch, cache_len), EMPTY_SLOT, dtype=torch.int32,
                       device=device))


def prefill(cfg, params, tokens: torch.Tensor, margin: int = 0, *,
            moe_routings: Optional[list] = None) -> Tuple[torch.Tensor, Cache]:
    """Processes prompts tokens (B, S); returns (last-token logits (B, V),
    cache).

    ``margin`` reserves headroom in the returned cache for the decode steps
    that follow (full attention); a sliding-window cache keeps the last
    ``window`` positions, rolled so that slot == pos % clen. ``moe_routings``:
    a list to which every MoE layer appends its ``moe.Routing``."""
    bsz, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    per_layer = []
    for lp in params["layers"]:
        x, layer_cache, _ = _layer_fwd(cfg, lp, x, positions, "full", None,
                                       None, moe_routings)
        per_layer.append(layer_cache)
    logits = _logits(cfg, params, x[:, -1:, :])

    clen = cache_len_for(cfg, s + margin)
    L = len(per_layer)
    n = min(s, clen)
    leaves = []
    for j, c0 in enumerate(per_layer[0]):       # (B, S, ...) per layer
        leaf = torch.zeros((L, bsz, clen) + tuple(c0.shape[2:]),
                           dtype=c0.dtype, device=c0.device)
        for i, layer_cache in enumerate(per_layer):
            c = layer_cache[j]
            if clen < s:   # window truncation: keep the last clen, slot order
                c = torch.roll(c[:, -clen:], shifts=s % clen, dims=1)
            leaf[i, :, :n] = c
        leaves.append(leaf)
    if clen < s:
        slot_vals = torch.roll(torch.arange(s - clen, s, dtype=torch.int32,
                                            device=x.device), s % clen)
    else:
        slot_vals = torch.cat([
            torch.arange(s, dtype=torch.int32, device=x.device),
            torch.full((clen - s,), EMPTY_SLOT, dtype=torch.int32,
                       device=x.device)])
    # per-row slot positions (L, B, clen): decode advances each row at its
    # own position (continuous batching over ragged prompts)
    slot_pos = slot_vals[None, None, :].expand(L, bsz, clen).contiguous()
    return logits[:, 0], (leaves[0], leaves[1], slot_pos)


def decode_step(cfg, params, cache: Cache, token: torch.Tensor, pos, *,
                moe_routings: Optional[list] = None) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token (B,); pos a scalar (every row at the same
    position) or (B,) per-row positions — the continuous-batching case,
    where ragged prompts put each cache row at its own length. Each row
    writes its cache entry at its own slot, in place in ``cache``, and
    attends only to its own history. ``moe_routings`` as for ``prefill``.

    Returns (logits (B, V), cache) — the cache tensors given, updated."""
    x = _embed(cfg, params, token[:, None])
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1)
    pos_b = pos_b.expand(token.shape[0]).contiguous()          # (B,)
    positions = pos_b[:, None]                                  # (B, 1)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _layer_fwd(cfg, lp, x, positions, "decode",
                             tuple(c[i] for c in cache), pos_b, moe_routings)
    return _logits(cfg, params, x)[:, 0], cache


def param_bytes(params) -> int:
    """Bytes of every parameter tensor."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return total
