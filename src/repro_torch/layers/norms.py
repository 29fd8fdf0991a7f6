"""RMS normalisation (fp32 statistics, cast back to the input dtype), with
the casts where the reference puts them (``repro.layers.norms``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * scale.to(torch.float32)).to(x.dtype)
