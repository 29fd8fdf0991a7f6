"""Plain PyTorch version of GQA one-token decode attention (the port of
``repro.kernels.decode_attention.ref.decode_attention_ref``).

Scores, softmax and p·V are in fp32 and the result is cast to q's dtype;
a row with no valid position gives 0 (the kernel's clamped denominator).
"""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, hd); k/v (B, S, Hkv, hd); valid (B, S) -> (B, Hkv, G, hd)."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isfinite(scores), p, 0.0)
    return torch.einsum("bhgs,bshd->bhgd", p, vf).to(q.dtype)
