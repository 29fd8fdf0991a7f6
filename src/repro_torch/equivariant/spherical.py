"""Real spherical harmonics and real-basis Wigner-D blocks, the port of
``repro.equivariant.spherical``.

Layout: flat (l, m) with index l² + (m + l), m ∈ [-l, l]; real convention
  Y_{l,-|m|} ∝ P_l^{|m|}(cosθ)·sin(|m|φ),  Y_{l,+|m|} ∝ P_l^{|m|}(cosθ)·cos(|m|φ)
orthonormalised over the sphere (∫ Y² dΩ = 1). Differentiable away from the
poles/origin; inputs are unit-safe (r=0 maps to ẑ).

The Wigner-D blocks follow the reference's Ivanic–Ruedenberg recurrence
term for term, but not entry by entry: ``_p_func`` / ``_u_func`` /
``_v_func`` / ``_w_func`` return each entry's terms as (coefficient,
D^1 entry, D^{l-1} entry) on the host, and ``wigner_d_from_rotation``
evaluates every entry of D^l at once from a gather of both factors, a
product and a sum over the terms: a few launches per l, where the
reference's form is one small elementwise op per term and entry (about
6,000 for l ≤ 6).
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch


def sh_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def sh_index(l: int, m: int) -> int:
    return l * l + (m + l)


def real_sph_harm(vectors: torch.Tensor, l_max: int) -> torch.Tensor:
    """vectors (..., 3) -> (..., (l_max+1)^2) orthonormal real SH."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    safe = r > 1e-12
    rs = torch.where(safe, r, 1.0)
    ct = torch.where(safe, z / rs, 1.0)                     # cosθ
    rho = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))  # sinθ·r
    st = torch.where(safe, rho / rs, 0.0)                   # sinθ ≥ 0
    cphi = torch.where(rho > 1e-12, x / rho, 1.0)
    sphi = torch.where(rho > 1e-12, y / rho, 0.0)

    # associated Legendre P_l^m(ct) with Condon–Shortley, m >= 0, recurrence:
    #   P_m^m = (-1)^m (2m-1)!! st^m
    #   P_{m+1}^m = ct (2m+1) P_m^m
    #   P_l^m = ((2l-1) ct P_{l-1}^m - (l+m-1) P_{l-2}^m) / (l - m)
    P = {}
    pmm = torch.ones_like(ct)
    for m in range(l_max + 1):
        if m > 0:
            pmm = pmm * (-(2 * m - 1)) * st
        P[(m, m)] = pmm
        if m + 1 <= l_max:
            P[(m + 1, m)] = ct * (2 * m + 1) * pmm
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    # cos(mφ), sin(mφ) by recurrence
    cos_m = [torch.ones_like(cphi), cphi]
    sin_m = [torch.zeros_like(sphi), sphi]
    for m in range(2, l_max + 1):
        cos_m.append(2 * cphi * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cphi * sin_m[-1] - sin_m[-2])

    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            # orthonormal normalisation; (-1)^m cancels Condon–Shortley so the
            # real SH are the standard (positive) tesseral harmonics
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am) / math.factorial(l + am))
            if m != 0:
                norm *= math.sqrt(2.0)
            sign = (-1.0) ** am
            base = sign * norm * P[(l, am)]
            if m < 0:
                out.append(base * sin_m[am])
            elif m == 0:
                out.append(base)
            else:
                out.append(base * cos_m[am])
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Real-basis Wigner D via the Ivanic–Ruedenberg recurrence
# ---------------------------------------------------------------------------

# a term: (coefficient, (i, j) of D^1, (a, b) of D^{l-1}), signed indices
Term = Tuple[float, Tuple[int, int], Tuple[int, int]]


def _p_func(i: int, l: int, a: int, b: int) -> List[Term]:
    """Ivanic–Ruedenberg helper P_i(l; a, b) as its terms."""
    if b == l:
        return [(1.0, (i, 1), (a, l - 1)), (-1.0, (i, -1), (a, -(l - 1)))]
    if b == -l:
        return [(1.0, (i, 1), (a, -(l - 1))), (1.0, (i, -1), (a, l - 1))]
    return [(1.0, (i, 0), (a, b))]


def _scaled(terms: List[Term], s: float) -> List[Term]:
    return [(c * s, d1, dl) for c, d1, dl in terms]


def _uvw(l, m, n):
    """Ivanic–Ruedenberg (1996, with 1998 errata) u, v, w coefficients."""
    d = 1.0 if m == 0 else 0.0
    denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
    u = math.sqrt((l + m) * (l - m) / denom)
    v = 0.5 * math.sqrt((1 + d) * (l + abs(m) - 1) * (l + abs(m)) / denom) * (1 - 2 * d)
    w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - d)
    return u, v, w


def _u_func(l, m, n) -> List[Term]:
    return _p_func(0, l, m, n)


def _v_func(l, m, n) -> List[Term]:
    if m == 0:
        return _p_func(1, l, 1, n) + _p_func(-1, l, -1, n)
    if m > 0:
        d1 = 1.0 if m == 1 else 0.0
        return (_scaled(_p_func(1, l, m - 1, n), math.sqrt(1 + d1))
                + _scaled(_p_func(-1, l, -m + 1, n), -(1 - d1)))
    d1 = 1.0 if m == -1 else 0.0
    return (_scaled(_p_func(1, l, m + 1, n), 1 - d1)
            + _scaled(_p_func(-1, l, -m - 1, n), math.sqrt(1 + d1)))


def _w_func(l, m, n) -> List[Term]:
    if m == 0:
        raise AssertionError("w term vanishes for m == 0")
    if m > 0:
        return _p_func(1, l, m + 1, n) + _p_func(-1, l, -m - 1, n)
    return _p_func(1, l, m - 1, n) + _scaled(_p_func(-1, l, -m + 1, n), -1.0)


def entry_terms(l: int, m: int, n: int) -> List[Term]:
    """The terms of D^l[m, n] (l >= 2): u·U + v·V + w·W, each part taken
    where its coefficient is nonzero, as the reference's recurrence takes
    it; terms with a zero coefficient dropped."""
    u, v, w = _uvw(l, m, n)
    terms = []
    if abs(u) > 1e-14:
        terms += _scaled(_u_func(l, m, n), u)
    if abs(v) > 1e-14:
        terms += _scaled(_v_func(l, m, n), v)
    if abs(w) > 1e-14:
        terms += _scaled(_w_func(l, m, n), w)
    return [t for t in terms if t[0] != 0.0]


@functools.lru_cache(maxsize=None)
def _tables_np(l: int):
    """D^l's terms as (I, J, C), each (S, K), S = (2l+1)² entries in
    row-major (m, n) order, K the most terms of an entry (the rest padded
    with coefficient 0): I indexes the flattened D^1 (3 × 3), J the
    flattened D^{l-1} ((2l-1)²)."""
    rows = [entry_terms(l, m, n) for m in range(-l, l + 1)
            for n in range(-l, l + 1)]
    k = max(len(t) for t in rows)
    size1 = 2 * l - 1
    I = np.zeros((len(rows), k), np.int64)
    J = np.zeros((len(rows), k), np.int64)
    C = np.zeros((len(rows), k), np.float64)
    for s, terms in enumerate(rows):
        for t, (c, (i, j), (a, b)) in enumerate(terms):
            I[s, t] = (i + 1) * 3 + (j + 1)
            J[s, t] = (a + l - 1) * size1 + (b + l - 1)
            C[s, t] = c
    return I, J, C


@functools.lru_cache(maxsize=None)
def _tables(l: int, device: str, dtype: torch.dtype):
    I, J, C = _tables_np(l)
    return (torch.as_tensor(I, device=device), torch.as_tensor(J, device=device),
            torch.as_tensor(C, dtype=dtype, device=device))


def wigner_d_from_rotation(R: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Real-basis Wigner-D blocks for rotation matrices R (..., 3, 3).

    Returns list [D^0 (...,1,1), D^1 (...,3,3), ..., D^{l_max}]. Equivariance:
    real_sph_harm(v @ R.T)_l == D^l @ real_sph_harm(v)_l.
    """
    batch = R.shape[:-2]
    D0 = torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)
    if l_max == 0:
        return [D0]
    # real-SH order (m = -1, 0, 1) ~ (y, z, x): D^1 = permuted R
    perm = [1, 2, 0]
    D1 = R[..., perm, :][..., :, perm]
    Ds = [D0, D1]
    d1 = D1.reshape(batch + (9,))
    for l in range(2, l_max + 1):
        I, J, C = _tables(l, str(R.device), R.dtype)
        dl = Ds[-1].reshape(batch + ((2 * l - 1) ** 2,))
        prod = d1[..., I] * dl[..., J] * C               # (..., S, K)
        Ds.append(prod.sum(-1).reshape(batch + (2 * l + 1, 2 * l + 1)))
    return Ds


def rotation_to_align_z(vec: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) with R @ v̂ = ẑ (eSCN edge-frame alignment)."""
    v = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=-1, keepdim=True),
                          min=1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    # axis = v × ẑ, angle = arccos(z); Rodrigues. Degenerate v ≈ ±ẑ handled.
    zero = torch.zeros_like(x)
    ax = torch.stack([y, -x, zero], dim=-1)
    s = torch.linalg.vector_norm(ax, dim=-1)
    c = z
    safe = s > 1e-8
    axn = ax / torch.clamp(s, min=1e-12)[..., None]
    a1, a2, a3 = axn[..., 0], axn[..., 1], axn[..., 2]
    K = torch.stack([torch.stack([zero, -a3, a2], -1),
                     torch.stack([a3, zero, -a1], -1),
                     torch.stack([-a2, a1, zero], -1)], -2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    R = eye + s[..., None, None] * K + (1 - c)[..., None, None] * (K @ K)
    flip = torch.eye(3, dtype=v.dtype, device=v.device)
    flip[1, 1] = flip[2, 2] = -1.0                      # diag(1, -1, -1)
    flip = flip.expand(K.shape)
    return torch.where(safe[..., None, None], R,
                       torch.where(c[..., None, None] > 0, eye, flip))
