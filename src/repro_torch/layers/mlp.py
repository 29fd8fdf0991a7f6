"""SwiGLU feed-forward (LLaMA convention: w1=gate, w3=up, w2=down)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.params import Init


def init_swiglu(cfg, init: Init, d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {"w1": init.dense((d, f), fan_in=d),
            "w3": init.dense((d, f), fan_in=d),
            "w2": init.dense((f, d), fan_in=f)}


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = x @ p["w1"].to(dtype)
    u = x @ p["w3"].to(dtype)
    return (F.silu(g) * u) @ p["w2"].to(dtype)
