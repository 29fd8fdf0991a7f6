"""AdamW with global-norm clipping and cosine / constant schedules (the
port of ``repro.train.optimizer``).

The moments are fp32 on each parameter's device. As in the reference,
``lr`` and the bias corrections ``1 - b**step`` are fp32 tensors computed
from the fp32 step (Python doubles would round otherwise), the clip scale
is ``min(1, clip / (‖g‖ + 1e-9))``, and weight decay applies to every leaf,
biases included. ``adamw_update`` returns new trees and leaves its inputs
as they were. The port keeps no logical axes, so the reference's
``opt_state_axes`` has no twin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.common.tree import global_norm, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # "cosine" | "constant"
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: object
    nu: object


def init_adamw(params) -> AdamWState:
    """Zero fp32 moments beside each parameter; the step on the device of
    the first leaf."""
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """fp32 learning rate at ``step`` (a tensor): linear warm-up, then
    cosine decay to ``min_lr_frac`` (or constant)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}). Grads
    may be bf16; the math is fp32, the new params keep their dtype."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        p32 = p.to(torch.float32)
        step_ = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * step_).to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                   state.mu, state.nu)
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)   # noqa: E731
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), metrics
