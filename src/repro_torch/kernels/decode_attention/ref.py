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


# The kernel against this plain version in bfloat16, output by output: both
# round one fp32 result to bfloat16, so an output may differ by one bf16 ulp
# of itself (at most 2^-7 of it), plus what the fp32 summation order moves
# an output near 0 by (far under 2^-16). A bound scaled to each output:
# outputs of long histories are small (|out| ~ 0.01 over 32k positions).
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 2.0 ** -16


def bf16_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over outputs of |got - ref| / (BF16_RTOL |ref| + BF16_FLOOR):
    at most 1 where the kernel agrees with its plain version."""
    r = ref.float()
    return float(((got.float() - r).abs()
                  / (BF16_RTOL * r.abs() + BF16_FLOOR)).max())
