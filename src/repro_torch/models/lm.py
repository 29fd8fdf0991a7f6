"""The RAG engine's transformer LM, serving half: init, prefill with
KV-cache production, and one-token decode with per-slot positions (the
port of ``repro.models.lm``).

Dense GQA only (optionally with QKV bias and a sliding window): a config
with ``attention="mla"`` or ``moe=True`` raises ``NotImplementedError``.
The reference's ``lax.scan`` over stacked layers is a Python loop over
per-layer parameters here. Training (``forward``, ``xent_loss``,
``loss_fn``, ``make_train_step`` and the bf16 gradient barrier) is not
ported yet.

Parameters are a dict: ``embed`` (V, D), ``final_ln`` (D,), ``head``
(D, V) when embeddings are untied, and ``layers``, a list of per-layer
dicts ``{"attn": {wq, wk, wv, wo[, bq, bk, bv]}, "ln1", "ln2", "ffn":
{w1, w3, w2}}``. The cache is a tuple of (L, B, clen, Hkv, hd) K and V
tensors and an (L, B, clen) int32 tensor of the position held in each
slot (-10^9 when empty), laid out as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.params import Init, dtype_of, resolve_device
from repro_torch.layers.attention import gqa_forward, init_gqa
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.norms import rms_norm

Cache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
EMPTY_SLOT = -(10 ** 9)


def check_supported(cfg) -> None:
    if cfg.attention != "gqa" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.arch_id or 'this config'}: only dense GQA is ported to "
            f"repro_torch (attention={cfg.attention!r}, moe={cfg.moe}); MLA "
            "and MoE layers are ROADMAP.md Queue 1 item 16")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg, init: Init) -> Dict[str, object]:
    return {"attn": init_gqa(cfg, init),
            "ln1": init.ones((cfg.d_model,)),
            "ln2": init.ones((cfg.d_model,)),
            "ffn": init_swiglu(cfg, init)}


def init_lm(cfg, seed: int = 0, *, device=None) -> Dict[str, object]:
    """Seeded random parameters in ``cfg.dtype``, made on ``device`` (None =
    the CUDA device; raises without one). The draws differ from the
    reference's ``init_lm`` for the same seed."""
    check_supported(cfg)
    device = resolve_device(device, "init_lm")
    init = Init(seed, device, dtype_of(cfg.dtype))
    params: Dict[str, object] = {
        "embed": init.dense((cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = init.dense((cfg.d_model, cfg.vocab_size),
                                    fan_in=cfg.d_model)
    params["final_ln"] = init.ones((cfg.d_model,))
    params["layers"] = [_init_layer(cfg, init) for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, lp, x, positions, mode, cache_l, cache_pos):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, new_cache = gqa_forward(cfg, lp["attn"], h, positions, mode=mode,
                               cache=cache_l, cache_pos=cache_pos)
    x = x + h
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(lp["ffn"], hn), new_cache


def _logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["head"].to(x.dtype)


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype_of(cfg.dtype))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_len_for(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg, batch: int, cache_len: int, *, device=None) -> Cache:
    """An empty KV cache (zeros, every slot position -10^9) with a leading
    L axis. device: None = the CUDA device."""
    check_supported(cfg)
    device = resolve_device(device, "init_cache")
    dt = dtype_of(cfg.dtype)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (L, batch, cache_len, hkv, hd)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device),
            torch.full((L, batch, cache_len), EMPTY_SLOT, dtype=torch.int32,
                       device=device))


def prefill(cfg, params, tokens: torch.Tensor,
            margin: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Processes prompts tokens (B, S); returns (last-token logits (B, V),
    cache).

    ``margin`` reserves headroom in the returned cache for the decode steps
    that follow (full attention); a sliding-window cache keeps the last
    ``window`` positions, rolled so that slot == pos % clen."""
    check_supported(cfg)
    bsz, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    kv = []
    for lp in params["layers"]:
        x, layer_kv = _layer_fwd(cfg, lp, x, positions, "full", None, None)
        kv.append(layer_kv)
    logits = _logits(cfg, params, x[:, -1:, :])

    clen = cache_len_for(cfg, s + margin)
    L = len(kv)
    k0 = kv[0][0]
    k_cache = torch.zeros((L, bsz, clen) + tuple(k0.shape[2:]),
                          dtype=k0.dtype, device=k0.device)
    v_cache = torch.zeros_like(k_cache)
    for i, (k, v) in enumerate(kv):
        if clen < s:   # window truncation: keep the last clen, slot order
            k = torch.roll(k[:, -clen:], shifts=s % clen, dims=1)
            v = torch.roll(v[:, -clen:], shifts=s % clen, dims=1)
        n = min(s, clen)
        k_cache[i, :, :n] = k
        v_cache[i, :, :n] = v
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
    return logits[:, 0], (k_cache, v_cache, slot_pos)


def decode_step(cfg, params, cache: Cache, token: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token (B,); pos a scalar (every row at the same
    position) or (B,) per-row positions — the continuous-batching case,
    where ragged prompts put each cache row at its own length. Each row
    writes its K/V at its own slot, in place in ``cache``, and attends only
    to its own history.

    Returns (logits (B, V), cache) — the cache tensors given, updated."""
    check_supported(cfg)
    x = _embed(cfg, params, token[:, None])
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1)
    pos_b = pos_b.expand(token.shape[0]).contiguous()          # (B,)
    positions = pos_b[:, None]                                  # (B, 1)
    k_all, v_all, p_all = cache
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer_fwd(cfg, lp, x, positions, "decode",
                          (k_all[i], v_all[i], p_all[i]), pos_b)
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
