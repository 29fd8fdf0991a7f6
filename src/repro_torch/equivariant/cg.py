"""Real-basis Clebsch–Gordan (coupling) tensors, the port of
``repro.equivariant.cg``: numpy float64, the same arithmetic as the
reference, so each tensor equals the reference's bit for bit.

Rather than transcribing Racah's formula + complex→real basis changes (sign
conventions are a classic bug farm), each C^{l1 l2 l3} is solved *numerically
in float64* as the null space of the equivariance constraint

    (D3 ⊗ D1 ⊗ D2)ᵀ vec(C) = vec(C)   for random rotations R

using the same Ivanic–Ruedenberg D matrices the models use at runtime — so
CG ⊗ D consistency is exact by construction. Coupling multiplicities are 1,
so the null space is 1-dimensional; tensors are normalised to ‖C‖=1 and
cached per (l1, l2, l3).
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np

from repro_torch.equivariant import spherical as sph


def _wigner_d_np(R: np.ndarray, l_max: int) -> List[np.ndarray]:
    """Float64 numpy mirror of spherical.wigner_d_from_rotation (setup only)."""
    batch = R.shape[:-2]
    D0 = np.ones(batch + (1, 1))
    perm = [1, 2, 0]
    D1 = R[..., perm, :][..., :, perm]
    Ds = [D0, D1]

    def d1(i_, j_):
        return D1[..., i_ + 1, j_ + 1]

    for l in range(2, l_max + 1):
        Dl1 = Ds[-1]

        def dl(a_, b_):
            return Dl1[..., a_ + (l - 1), b_ + (l - 1)]

        def p_func(i, a, b):
            if b == l:
                return d1(i, 1) * dl(a, l - 1) - d1(i, -1) * dl(a, -(l - 1))
            if b == -l:
                return d1(i, 1) * dl(a, -(l - 1)) + d1(i, -1) * dl(a, l - 1)
            return d1(i, 0) * dl(a, b)

        rows = []
        for m in range(-l, l + 1):
            row = []
            for n in range(-l, l + 1):
                u, v, w = sph._uvw(l, m, n)
                term = np.zeros(batch)
                if abs(u) > 1e-14:
                    term = term + u * p_func(0, m, n)
                if abs(v) > 1e-14:
                    if m == 0:
                        pv = p_func(1, 1, n) + p_func(-1, -1, n)
                    elif m > 0:
                        dd = 1.0 if m == 1 else 0.0
                        pv = (p_func(1, m - 1, n) * math.sqrt(1 + dd)
                              - p_func(-1, -m + 1, n) * (1 - dd))
                    else:
                        dd = 1.0 if m == -1 else 0.0
                        pv = (p_func(1, m + 1, n) * (1 - dd)
                              + p_func(-1, -m - 1, n) * math.sqrt(1 + dd))
                    term = term + v * pv
                if abs(w) > 1e-14:
                    if m > 0:
                        pw = p_func(1, m + 1, n) + p_func(-1, -m - 1, n)
                    else:
                        pw = p_func(1, m - 1, n) - p_func(-1, -m + 1, n)
                    term = term + w * pw
                row.append(term)
            rows.append(np.stack(row, axis=-1))
        Ds.append(np.stack(rows, axis=-2))
    return Ds[: l_max + 1]


def _rand_rot(rng) -> np.ndarray:
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real coupling tensor C (2l3+1, 2l1+1, 2l2+1), ‖C‖=1; zeros if forbidden."""
    n3, n1, n2 = 2 * l3 + 1, 2 * l1 + 1, 2 * l2 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((n3, n1, n2))
    # the hash of a tuple of ints is fixed (no hash randomisation for ints)
    rng = np.random.default_rng(hash((l1, l2, l3)) % (2 ** 32))
    lmax = max(l1, l2, l3)
    rows = []
    for _ in range(3):
        R = _rand_rot(rng)
        Ds = _wigner_d_np(R, lmax)
        M = np.kron(np.kron(Ds[l3], Ds[l1]), Ds[l2]).T
        rows.append(M - np.eye(M.shape[0]))
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    null_dim = int(np.sum(s < 1e-8))
    if null_dim != 1:
        raise ArithmeticError(f"CG({l1}, {l2}, {l3}): null space of "
                              f"dimension {null_dim} (last singular values "
                              f"{s[-3:]})")
    c = vt[-1].reshape(n3, n1, n2)
    # deterministic sign: first nonzero entry positive
    flat = c.reshape(-1)
    nz = flat[np.abs(flat) > 1e-10]
    if len(nz) and nz[0] < 0:
        c = -c
    return c


def paths(l_max_in: int, l_max_sh: int, l_max_out: int) -> List[Tuple[int, int, int]]:
    """All allowed (l_in, l_sh, l_out) coupling paths."""
    out = []
    for l1 in range(l_max_in + 1):
        for l2 in range(l_max_sh + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max_out) + 1):
                out.append((l1, l2, l3))
    return out
