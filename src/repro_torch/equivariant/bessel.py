"""Spherical Bessel radial bases (DimeNet) + smooth cutoff envelopes, the
port of ``repro.equivariant.bessel``.

j_l via upward recurrence from the closed forms j0 = sin(x)/x,
j1 = sin(x)/x² − cos(x)/x (stable for the x = z_{ln}·r/c > l/2 regime the
basis evaluates — zeros of j_l all exceed l). Zeros found at init by
bisection on the closed forms (numpy float64, no scipy), as the reference
finds them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _jl_np(l: int, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    safe = np.where(np.abs(x) < 1e-8, 1e-8, x)
    j0 = np.sin(safe) / safe
    if l == 0:
        return j0
    j1 = np.sin(safe) / safe ** 2 - np.cos(safe) / safe
    if l == 1:
        return j1
    jm2, jm1 = j0, j1
    for n in range(2, l + 1):
        jm2, jm1 = jm1, (2 * n - 1) / safe * jm1 - jm2
    return jm1


@functools.lru_cache(maxsize=None)
def bessel_zeros(l_max: int, n_zeros: int) -> np.ndarray:
    """(l_max+1, n_zeros) first zeros of j_l, by bracketed bisection."""
    out = np.zeros((l_max + 1, n_zeros))
    for l in range(l_max + 1):
        found = []
        # zeros of j_l interlace those of j_{l-1}; scan in fine steps
        x0, step = l + 1e-3, 0.1
        x = x0
        prev = _jl_np(l, np.array([x]))[0]
        while len(found) < n_zeros:
            x += step
            cur = _jl_np(l, np.array([x]))[0]
            if prev * cur < 0:
                a, b = x - step, x
                for _ in range(60):
                    mid = 0.5 * (a + b)
                    fm = _jl_np(l, np.array([mid]))[0]
                    if _jl_np(l, np.array([a]))[0] * fm <= 0:
                        b = mid
                    else:
                        a = mid
                found.append(0.5 * (a + b))
            prev = cur
        out[l] = found
    return out


@functools.lru_cache(maxsize=None)
def _sbf_constants(n_spherical: int, n_radial: int, cutoff: float):
    """(zeros, norms), each (n_spherical, n_radial) float32 numpy: the
    zeros of j_l and the basis's normalisation √2 / |j_{l+1}(z)| / c^1.5."""
    zeros = bessel_zeros(n_spherical - 1, n_radial)
    norms = np.asarray(
        [[math.sqrt(2.0) / abs(_jl_np(l + 1, np.array([z]))[0]) / cutoff ** 1.5
          for z in zeros[l]] for l in range(n_spherical)], np.float32)
    return zeros.astype(np.float32), norms


def jl(l: int, x: torch.Tensor) -> torch.Tensor:
    """Differentiable spherical Bessel j_l (torch, recurrence)."""
    safe = torch.where(torch.abs(x) < 1e-6, 1e-6, x)
    j0 = torch.sin(safe) / safe
    if l == 0:
        return j0
    j1 = torch.sin(safe) / safe ** 2 - torch.cos(safe) / safe
    if l == 1:
        return j1
    jm2, jm1 = j0, j1
    for n in range(2, l + 1):
        jm2, jm1 = jm1, (2 * n - 1) / safe * jm1 - jm2
    return jm1


def envelope(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """DimeNet polynomial cutoff envelope u(d), d = r/c (smooth to p-th
    derivative; contains the basis's 1/d factor). d is floored at 0.02 as a
    numerical guard — physical graphs never reach d→0, synthetic ones can."""
    d = torch.clamp(r / cutoff, min=0.02)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    env = 1.0 / d + a * d ** (p - 1) + b * d ** p + c * d ** (p + 1)
    return torch.where(d < 1.0, env, 0.0)


def radial_bessel_basis(r: torch.Tensor, n_radial: int,
                        cutoff: float) -> torch.Tensor:
    """DimeNet RBF: u(d)·√(2/c)·sin(nπ d). r (...,) -> (..., n)."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=r.device)
    d = torch.clamp(r / cutoff, min=0.02)[..., None]
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d)
    return basis * envelope(r, cutoff)[..., None]


def spherical_bessel_basis(r: torch.Tensor, n_spherical: int, n_radial: int,
                           cutoff: float) -> torch.Tensor:
    """DimeNet SBF radial part: j_l(z_{ln} r/c), (..., n_spherical, n_radial)."""
    zeros_np, norms_np = _sbf_constants(n_spherical, n_radial, float(cutoff))
    zeros = torch.as_tensor(zeros_np, device=r.device)
    norms = torch.as_tensor(norms_np, device=r.device)
    rs = (r / cutoff)[..., None]
    outs = []
    for l in range(n_spherical):
        x = zeros[l][None, :] * rs                      # (..., n_radial)
        outs.append(jl(l, x) * norms[l])
    out = torch.stack(outs, dim=-2)                     # (..., n_sph, n_rad)
    return out * envelope(r, cutoff)[..., None, None]


def angular_basis(angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """DimeNet CBF angular part: Legendre P_l(cos θ) (..., n_spherical)."""
    c = torch.cos(angle)
    ps = [torch.ones_like(c), c]
    for l in range(2, n_spherical):
        ps.append(((2 * l - 1) * c * ps[-1] - (l - 1) * ps[-2]) / l)
    return torch.stack(ps[:n_spherical], dim=-1)
