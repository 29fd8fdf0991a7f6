"""Multi-head latent attention (DeepSeek-V2), the port of
``repro.layers.mla``: prefill materialises per-head K/V from the latent;
decode uses the weight-absorbed form, so the cache holds only (latent,
roped k) per token — kv_lora_rank + qk_rope_head_dim values per token and
layer — and w_uk / w_uv fold into the query and output paths.

Layouts are the reference's: wq (d, H, dn+dr), w_dkv (d, r), w_krope
(d, dr), w_uk (r, H, dn), w_uv (r, H, dv), wo (H, dv, d). The absorbed
decode is plain batched matmuls (the reference's einsums, outside any
Pallas kernel there too).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.params import Init
from repro_torch.layers.attention import _project, attend_full
from repro_torch.layers.rope import apply_rope
from repro_torch.sharding.rules import with_sharding


def init_mla(cfg, init: Init) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return {"wq": init.dense((d, h, dn + dr), fan_in=d),
            "w_dkv": init.dense((d, r), fan_in=d),
            "w_krope": init.dense((d, dr), fan_in=d),
            "w_uk": init.dense((r, h, dn), fan_in=r),
            "w_uv": init.dense((r, h, dv), fan_in=r),
            "wo": init.dense((h, dv, d), fan_in=h * dv)}


def mla_forward(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str, cache=None,
                cache_pos=None, q_block: int = 0, mesh=None):
    """One attention sublayer.

    mode "full":   x (B, S, D), positions (S,); returns (out, (latent,
                   k_rope)) with latent (B, S, r) and k_rope (B, S, dr) —
                   prefill and training, attending over the materialised
                   K/V (scaled in q's dtype by 1/√(dn+dr), softmax in fp32;
                   ``q_block`` as for ``attend_full``).
    mode "decode": x (B, 1, D), positions (B, 1), cache = (latent, k_rope,
                   slot_pos) of this layer ((B, clen, r), (B, clen, dr),
                   (B, clen) int32), cache_pos (B,). Each row writes its
                   latent, roped k and position at slot ``pos % clen`` in
                   place, then attends in the absorbed form: scores
                   q_nope·W_uk·latentᵀ + q_rope·k_ropeᵀ in the model dtype,
                   cast to fp32 and divided by √(dn+dr), p cast back to the
                   model dtype before p·latent and ·W_uv. As in the
                   reference, a row with no valid slot gives NaN (the engine
                   never makes one). Returns (out, cache) — the same
                   tensors, updated.
    ``mesh``: the reference's sharding constraints, resolved
    (``with_sharding``); they change no value.
    """
    dtype = x.dtype
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h = cfg.n_heads
    q = _project(x, p["wq"])                                   # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    latent = x @ p["w_dkv"].to(dtype)                          # (B, S, r)
    k_rope = x @ p["w_krope"].to(dtype)                        # (B, S, dr)
    # roped with a singleton head axis, as in the reference
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if mode == "full":
        k_nope = _project(latent, p["w_uk"])                   # (B,S,H,dn)
        v = _project(latent, p["w_uv"])                        # (B,S,H,dv)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(*k_rope.shape[:2], h, dr)],
            dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = attend_full(q_full, k_full, v, positions, positions,
                          q_block=q_block)
        new_cache = (latent, k_rope)
    elif mode == "decode":
        lat_cache, rope_cache, slot_pos = cache
        bsz = x.shape[0]
        rows = torch.arange(bsz, device=x.device)
        slot = cache_pos % lat_cache.shape[1]
        lat_cache[rows, slot] = latent[:, 0]
        rope_cache[rows, slot] = k_rope[:, 0]
        slot_pos[rows, slot] = cache_pos.to(slot_pos.dtype)
        lat_cache = with_sharding(lat_cache, ("batch", "cache_seq", None),
                                  mesh)
        rope_cache = with_sharding(rope_cache, ("batch", "cache_seq", None),
                                   mesh)
        # absorbed scores: (q_nope · W_uk) · latentᵀ + q_rope · k_ropeᵀ,
        # the heads as the matmuls' batch axis
        w_uk = p["w_uk"].to(dtype).permute(1, 2, 0)             # (H, dn, r)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)  # (H, B, r)
        s = (q_lat.transpose(0, 1) @ lat_cache.transpose(1, 2)
             + q_rope[:, 0] @ rope_cache.transpose(1, 2))      # (B, H, T)
        s = s.to(torch.float32) / math.sqrt(dn + dr)
        valid = (slot_pos >= 0) & (slot_pos <= cache_pos[:, None])
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        s = s + torch.where(valid, zero, float("-inf"))[:, None, :]
        pr = torch.softmax(s, dim=-1).to(dtype)
        o_lat = pr @ lat_cache                                  # (B, H, r)
        w_uv = p["w_uv"].to(dtype).transpose(0, 1)              # (H, r, dv)
        out = torch.bmm(o_lat.transpose(0, 1), w_uv)            # (H, B, dv)
        out = out.transpose(0, 1)[:, None]                      # (B,1,H,dv)
        new_cache = (lat_cache, rope_cache, slot_pos)
    else:
        raise ValueError(mode)

    hh, dv = p["wo"].shape[0], p["wo"].shape[1]
    out = out.reshape(*out.shape[:2], hh * dv) @ p["wo"].to(dtype).reshape(
        hh * dv, -1)
    return out, new_cache
