"""Flash quantization (paper Eq. 2) with the adaptive bit-width policy.

    q = floor(levels * (e - min(e)) / (max(e) - min(e)))      per-vector affine

Supports 8-bit (int8 storage, codes centred at -128), 4-bit (two nibbles
packed per int8) and 16-bit (bf16 passthrough). The arithmetic is the
reference's, step for step in fp32, so int8 and 4-bit codes and their
vmin/scale are byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedVectors:
    data: torch.Tensor   # int8: (N, d) for 8-bit, (N, ceil(d/2)) packed for 4-bit; bf16 for 16
    vmin: torch.Tensor   # (N, 1) fp32
    scale: torch.Tensor  # (N, 1) fp32: (max-min)/levels
    bits: int = 8
    dim: int = 0         # original d (4-bit packing pads odd dims)

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.vmin.numel() * 4 + self.scale.numel() * 4)


def quantize(e: torch.Tensor, bits: int = 8) -> QuantizedVectors:
    """Per-vector affine quantization (Eq. 2 generalised to 4/8/16 bits)."""
    d = e.shape[-1]
    n = e.shape[0]
    if bits == 16:
        return QuantizedVectors(
            e.to(torch.bfloat16),
            torch.zeros((n, 1), dtype=torch.float32, device=e.device),
            torch.ones((n, 1), dtype=torch.float32, device=e.device), 16, d)
    ef = e.to(torch.float32)
    vmin = ef.amin(dim=-1, keepdim=True)
    vmax = ef.amax(dim=-1, keepdim=True)
    levels = (1 << bits) - 1
    scale = torch.clamp_min(vmax - vmin, 1e-12) / levels
    q = torch.clamp(torch.floor((ef - vmin) / scale), 0, levels)
    if bits == 8:
        data = (q - 128).to(torch.int8)                       # store centred
    elif bits == 4:
        if d % 2:
            q = torch.nn.functional.pad(q, (0, 1))            # pad odd dims
        qi = q.to(torch.uint8)
        lo, hi = qi[:, 0::2], qi[:, 1::2]
        data = (lo | (hi << 4)).view(torch.int8)
    else:
        raise ValueError(f"bits={bits}")
    return QuantizedVectors(data, vmin, scale, bits, d)


def _unpack4(data: torch.Tensor) -> torch.Tensor:
    """(..., d'/2) packed nibbles -> (..., d') fp32 levels."""
    u = data.view(torch.uint8)
    lo = (u & 0xF).to(torch.float32)
    hi = (u >> 4).to(torch.float32)
    return torch.stack([lo, hi], dim=-1).reshape(*u.shape[:-1], -1)


def dequantize(qv: QuantizedVectors) -> torch.Tensor:
    if qv.bits == 16:
        return qv.data.to(torch.float32)
    if qv.bits == 8:
        q = qv.data.to(torch.float32) + 128.0
    elif qv.bits == 4:
        q = _unpack4(qv.data)
        if qv.dim and q.shape[-1] != qv.dim:
            q = q[:, : qv.dim]                                # drop pad column
    else:
        raise ValueError(qv.bits)
    return q * qv.scale + qv.vmin


def quantized_scores(queries: torch.Tensor, qv: QuantizedVectors) -> torch.Tensor:
    """Dot-product scores without materialising dequantized vectors:

        q · e  =  scale_e * (q · qint)  +  min_e * sum(q)

    (the identity the fused scan kernels exploit). queries: (Q, d) -> (Q, N).
    """
    qf = queries.to(torch.float32)
    if qv.bits == 16:
        return qf @ qv.data.to(torch.float32).T
    if qv.bits != 8:   # 4-bit: unpack then dot
        return qf @ dequantize(qv).T
    qint = qv.data.to(torch.float32).T + 128.0                 # (d, N)
    dots = qf @ qint                                           # (Q, N)
    qsum = qf.sum(dim=-1, keepdim=True)                        # (Q, 1)
    return dots * qv.scale[:, 0][None, :] + qsum * qv.vmin[:, 0][None, :]


class AdaptiveQuantPolicy:
    """Memory-pressure driven bit selection (paper §3.3 "adaptive quantization")."""

    def __init__(self, budget_bytes: int = 0, high_water: float = 0.8,
                 low_water: float = 0.5):
        self.budget = budget_bytes
        self.high = high_water
        self.low = low_water

    def choose_bits(self, current_bytes: int, default_bits: int = 16) -> int:
        if not self.budget:
            return default_bits
        frac = current_bytes / self.budget
        if frac >= self.high:
            return 4 if default_bits <= 8 or frac >= 1.0 else 8
        if frac >= self.low:
            return 8
        return default_bits
