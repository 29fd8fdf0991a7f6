"""GQA attention with causal + sliding-window masking: prefill over a whole
prompt, and one-token decode against a KV cache through the CUDA
flash-decode kernel (``kernels/decode_attention``).

Layouts are the reference's (``repro.layers.attention``): activations
(B, S, H, hd), weights wq (d, Hq, hd), wk/wv (d, Hkv, hd), wo (Hq, hd, d),
head ``h = kv·G + g`` with G = Hq / Hkv.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.params import Init
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.layers.rope import apply_rope
from repro_torch.sharding.rules import with_sharding


def init_gqa(cfg, init: Init) -> Dict[str, torch.Tensor]:
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    p = {"wq": init.dense((d, hq, hd), fan_in=d),
         "wk": init.dense((d, hkv, hd), fan_in=d),
         "wv": init.dense((d, hkv, hd), fan_in=d),
         "wo": init.dense((hq, hd, d), fan_in=hq * hd)}
    if cfg.qkv_bias:
        p.update(bq=init.zeros((hq, hd)), bk=init.zeros((hkv, hd)),
                 bv=init.zeros((hkv, hd)))
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """(Sq, Skv) additive fp32 mask: causal plus optional sliding window."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_positions: torch.Tensor, k_positions: torch.Tensor, *,
                window: int = 0, q_block: int = 0) -> torch.Tensor:
    """Masked attention over a whole prompt (the reference's einsums). q/k
    (B, Sq|Skv, Hq|Hkv, hd), already roped; v (B, Skv, Hkv, dv), where dv
    may differ from hd (MLA: q/k 192 wide, v 128). Returns (B, Sq, Hq,
    dv); the scale is 1/√hd, q's width.

    ``q_block`` cuts the queries into blocks of that many rows, each
    attending to the whole K/V as below, as the reference's ``q_block``
    does: the fp32 scores live one block at a time, (B, Hkv, G·qb, Skv).
    One block when it is 0, not below Sq, or does not divide Sq (the
    reference's rule). Training passes ``ExecOpts.q_block``; prefill keeps
    one block."""
    sq = q.shape[1]
    qb = q_block if (q_block and q_block < sq) else sq
    if sq % qb:
        qb = sq
    if qb == sq:
        return _attend_block(q, k, v, q_positions, k_positions, window)
    return torch.cat([_attend_block(q[:, i:i + qb], k, v,
                                    q_positions[i:i + qb], k_positions,
                                    window)
                      for i in range(0, sq, qb)], dim=1)


def _attend_block(q, k, v, q_positions, k_positions, window):
    """One query block of ``attend_full``.

    The GQA groups are a batch axis of the matmul (q viewed as
    (B, Hkv, G·Sq, hd)), so K/V are never repeated per query head. Scores
    are scaled in q's dtype and softmaxed in fp32; p is cast back to q's
    dtype before p·V, as in the reference."""
    bsz, sq, hq, hd = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(bsz, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,Hkv,G,Sq,hd)
    qg = qg.reshape(bsz, hkv, g * sq, hd)
    kt = k.permute(0, 2, 3, 1)                                  # (B,Hkv,hd,Skv)
    s = (qg @ kt) * scale                                       # (B,Hkv,G·Sq,Skv)
    s = s.reshape(bsz, hkv, g, sq, skv).to(torch.float32)
    s = s + _mask_bias(q_positions, k_positions, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = p.reshape(bsz, hkv, g * sq, skv) @ v.permute(0, 2, 1, 3)  # (B,Hkv,G·Sq,dv)
    o = o.reshape(bsz, hkv, g, sq, dv).permute(0, 3, 1, 2, 4)
    return o.reshape(bsz, sq, hq, dv)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """One-token decode against a (B, S_cache, Hkv, hd) cache.

    q (B, 1, Hq, hd); valid_mask (B, S_cache) bool. Runs
    ``kernels.decode_attention.ops.decode_attention``: the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors. It follows the
    kernel's contract, which differs from the reference's einsum form
    (``repro.layers.attention.attend_decode``) in two ways:

    - the einsum form casts p to q's dtype before p·V; the kernel keeps p
      in fp32 (the same in fp32, closer to exact in bf16);
    - for a row with no valid position the einsum form gives NaN; the
      kernel gives 0.
    """
    bsz, one, hq, hd = q.shape
    out = decode_attention(q.reshape(bsz, hq, hd).contiguous(), k_cache,
                           v_cache, valid_mask)
    return out.reshape(bsz, one, hq, hd)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def gqa_forward(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str, cache=None,
                cache_pos=None, q_block: int = 0, mesh=None):
    """One attention sublayer.

    mode "full":   x (B, S, D), positions (S,); returns (out, (k, v)) with
                   k/v (B, S, Hkv, hd) — prefill and training; ``q_block``
                   as for ``attend_full``.
    mode "decode": x (B, 1, D), positions (B, 1), cache = (k_cache, v_cache,
                   slot_pos) of this layer ((B, clen, Hkv, hd) twice and
                   (B, clen) int32), cache_pos (B,) per-row positions.
                   Each row writes its K/V and position at slot
                   ``pos % clen`` **in place** into the given cache tensors
                   (a copy of the whole cache per step would move ~2 GB per
                   tick at phi4-mini's serving shape), then attends to its
                   own valid history. Returns (out, cache) — the same
                   tensors, updated.
    ``mesh``: the reference's sharding constraints, resolved
    (``with_sharding``); they change no value.
    """
    dtype = x.dtype
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "full":
        q = with_sharding(q, ("batch", "seq_attn", "act_heads", None), mesh)
        out = attend_full(q, k, v, positions, positions,
                          window=cfg.sliding_window, q_block=q_block)
        new_cache = (k, v)
    elif mode == "decode":
        k_cache, v_cache, slot_pos = cache
        bsz = x.shape[0]
        rows = torch.arange(bsz, device=x.device)
        slot = cache_pos % k_cache.shape[1]                 # rolling for SWA
        k_cache[rows, slot] = k[:, 0]
        v_cache[rows, slot] = v[:, 0]
        slot_pos[rows, slot] = cache_pos.to(slot_pos.dtype)
        k_cache = with_sharding(k_cache, ("batch", "cache_seq", None, None),
                                mesh)
        v_cache = with_sharding(v_cache, ("batch", "cache_seq", None, None),
                                mesh)
        pos_now = cache_pos[:, None]                        # (B, 1)
        valid = (slot_pos >= 0) & (slot_pos <= pos_now)
        if cfg.sliding_window:
            valid = valid & (slot_pos > pos_now - cfg.sliding_window)
        out = attend_decode(q, k_cache, v_cache, valid)
        new_cache = (k_cache, v_cache, slot_pos)
    else:
        raise ValueError(mode)

    hq, hd = p["wo"].shape[0], p["wo"].shape[1]
    out = out.reshape(*out.shape[:2], hq * hd) @ p["wo"].to(dtype).reshape(
        hq * hd, -1)
    return out, new_cache
