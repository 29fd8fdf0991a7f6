"""The port's equivariant library (``repro_torch.equivariant``): twins of
every case of ``tests/test_equivariant.py`` run on the port, and parity
with the JAX package's functions on seeded numpy inputs.

Tolerances: spherical harmonics, Wigner-D blocks and the edge-frame
rotation within 2e-6 absolute (fp32 values of magnitude ≤ ~1.5, summed in
another order); the Bessel bases within 1e-5 of each basis function's
largest |value| where the upward recurrence is stable (x = z·r/c ≥ l/2,
r ∈ [c/2, 1.2 c]: below it both sides' j_l amplify their own rounding).
``clebsch_gordan`` (numpy float64 on both sides) bit for bit: the whole
tensor for every path with l ≤ 2 (NequIP's), and for every path up to
l 6 the rotations and float64 Wigner-D blocks its constraint matrix is
built from (the same code on the same inputs gives the same bits; the
SVDs of all paths up to l 6 take minutes).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax.numpy as jnp
import torch

from repro.equivariant import bessel as j_bessel
from repro.equivariant import cg as j_cg
from repro.equivariant import spherical as j_sph
from repro_torch.equivariant.bessel import (_jl_np, angular_basis,
                                            bessel_zeros, envelope, jl,
                                            radial_bessel_basis,
                                            spherical_bessel_basis)
from repro_torch.equivariant import cg as t_cg
from repro_torch.equivariant.cg import (_rand_rot, _wigner_d_np,
                                        clebsch_gordan, paths)
from repro_torch.equivariant.spherical import (_uvw, real_sph_harm,
                                               rotation_to_align_z, sh_dim,
                                               sh_index,
                                               wigner_d_from_rotation)

FP32_ATOL = 2e-6
BASIS_RTOL = 1e-5


def _rot(seed):
    return _rand_rot(np.random.default_rng(seed))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


class TestSphericalHarmonics:
    def test_orthonormality_mc(self, rng):
        v = rng.normal(size=(100_000, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        y = real_sph_harm(torch.from_numpy(v), 3).numpy()
        gram = (y.T @ y) / len(v) * 4 * np.pi
        np.testing.assert_allclose(gram, np.eye(sh_dim(3)), atol=0.05)

    @pytest.mark.parametrize("l_max", [1, 2, 4, 6])
    def test_wigner_equivariance(self, l_max, rng):
        R = _t(np.stack([_rot(i) for i in range(3)]))
        v = _t(rng.normal(size=(3, 3)))
        y = real_sph_harm(v, l_max)
        yr = real_sph_harm(torch.einsum("bij,bj->bi", R, v), l_max)
        ds = wigner_d_from_rotation(R, l_max)
        for l in range(l_max + 1):
            sl = slice(l * l, (l + 1) * (l + 1))
            pred = torch.einsum("bmn,bn->bm", ds[l], y[:, sl])
            np.testing.assert_allclose(pred.numpy(), yr[:, sl].numpy(),
                                       atol=5e-5)

    def test_wigner_orthogonal(self):
        ds = wigner_d_from_rotation(_t(_rot(0)[None]), 4)
        for d in ds:
            m = d[0].numpy()
            np.testing.assert_allclose(m @ m.T, np.eye(len(m)), atol=1e-4)

    def test_align_z(self, rng):
        v = _t(rng.normal(size=(16, 3)))
        r = rotation_to_align_z(v)
        z = torch.einsum("bij,bj->bi", r,
                         v / torch.linalg.vector_norm(v, dim=1, keepdim=True))
        np.testing.assert_allclose(z.numpy(), [[0, 0, 1.0]] * 16, atol=1e-5)
        np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0,
                                   atol=1e-5)

    def test_align_z_degenerate_poles(self):
        v = torch.tensor([[0.0, 0, 1.0], [0.0, 0, -1.0]])
        r = rotation_to_align_z(v)
        z = torch.einsum("bij,bj->bi", r, v)
        np.testing.assert_allclose(z.numpy(), [[0, 0, 1.0]] * 2, atol=1e-6)


class TestClebschGordan:
    @pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 1, 2), (2, 2, 2),
                                          (3, 2, 1), (6, 2, 6)])
    def test_equivariance(self, l1, l2, l3):
        c = clebsch_gordan(l1, l2, l3)
        r = _rot(42)
        ds = _wigner_d_np(r, max(l1, l2, l3))
        lhs = np.einsum("mn,nab->mab", ds[l3], c)
        rhs = np.einsum("mab,ax,by->mxy", c, ds[l1], ds[l2])
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)

    def test_forbidden_paths_zero(self):
        assert np.allclose(clebsch_gordan(1, 1, 3), 0)
        assert np.allclose(clebsch_gordan(0, 2, 1), 0)

    def test_normalised(self):
        c = clebsch_gordan(2, 1, 2)
        assert abs(np.linalg.norm(c) - 1.0) < 1e-10


class TestBessel:
    def test_j0_zeros_are_n_pi(self):
        z = bessel_zeros(0, 4)
        np.testing.assert_allclose(z[0] / np.pi, [1, 2, 3, 4], rtol=1e-8)

    def test_zeros_are_roots(self):
        z = bessel_zeros(4, 3)
        for l in range(5):
            assert np.max(np.abs(_jl_np(l, z[l]))) < 1e-10

    def test_bases_finite_and_cutoff(self):
        r = torch.linspace(0.05, 6.0, 32)
        rb = radial_bessel_basis(r, 6, 5.0)
        sb = spherical_bessel_basis(r, 7, 6, 5.0)
        ab = angular_basis(torch.linspace(0, np.pi, 8), 7)
        for arr in (rb, sb, ab):
            assert bool(torch.all(torch.isfinite(arr)))
        # envelope: zero beyond the cutoff
        assert float(torch.max(torch.abs(rb[r > 5.0]))) == 0.0
        assert float(torch.max(torch.abs(sb[r > 5.0]))) == 0.0

    def test_legendre_recurrence(self):
        a = angular_basis(torch.tensor([0.3]), 4)[0].numpy()
        c = np.cos(0.3)
        want = [1, c, 0.5 * (3 * c ** 2 - 1), 0.5 * (5 * c ** 3 - 3 * c)]
        np.testing.assert_allclose(a, want, rtol=1e-5)


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("l_max", [0, 1, 2, 6])
def test_sph_harm_matches_reference(l_max):
    rng = np.random.default_rng(l_max)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -2], [0, 0, 0], [1e-7, 0, 1]]   # poles, 0
    want = np.asarray(j_sph.real_sph_harm(jnp.asarray(v), l_max))
    got = real_sph_harm(torch.from_numpy(v), l_max).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    assert sh_dim(l_max) == j_sph.sh_dim(l_max) == got.shape[-1]
    assert [sh_index(l, m) for l in range(l_max + 1)
            for m in range(-l, l + 1)] == list(range(sh_dim(l_max)))


@pytest.mark.parametrize("l_max", [0, 2, 6])
def test_wigner_d_matches_reference(l_max):
    R = np.stack([_rot(i) for i in range(24)]).astype(np.float32)
    want = j_sph.wigner_d_from_rotation(jnp.asarray(R), l_max)
    got = wigner_d_from_rotation(torch.from_numpy(R), l_max)
    assert len(got) == len(want) == l_max + 1
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=FP32_ATOL)


def test_wigner_terms_and_float64_mirror_match_reference():
    """The recurrence's coefficients and the float64 mirror CG is built
    from, bit for bit."""
    for l in range(2, 7):
        for m in range(-l, l + 1):
            for n in range(-l, l + 1):
                assert _uvw(l, m, n) == j_sph._uvw(l, m, n)
    R = np.stack([_rot(i) for i in range(5)])
    for a, b in zip(j_cg._wigner_d_np(R, 6), _wigner_d_np(R, 6)):
        assert np.array_equal(a, b)
    for s in range(5):
        assert np.array_equal(_rot(s), j_cg._rand_rot(np.random.default_rng(s)))


def test_rotation_to_align_z_matches_reference():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:3] = [[0, 0, 1], [0, 0, -3], [1e-9, 0, -1]]               # the poles
    want = np.asarray(j_sph.rotation_to_align_z(jnp.asarray(v)))
    got = rotation_to_align_z(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def _close_per_basis(got, want):
    """Within BASIS_RTOL of each basis function's largest |value|."""
    want = np.asarray(want).reshape(len(want), -1)
    got = np.asarray(got).reshape(len(got), -1)
    scale = np.maximum(np.abs(want).max(0), 1e-12)
    assert np.all(np.abs(got - want) <= BASIS_RTOL * scale), (
        np.abs(got - want).max(0) / scale)


def test_bessel_bases_match_reference():
    c = 5.0
    r = np.linspace(0.5 * c, 1.2 * c, 40).astype(np.float32)
    _close_per_basis(radial_bessel_basis(_t(r), 6, c).numpy(),
                     j_bessel.radial_bessel_basis(jnp.asarray(r), 6, c))
    _close_per_basis(spherical_bessel_basis(_t(r), 7, 6, c).numpy(),
                     j_bessel.spherical_bessel_basis(jnp.asarray(r), 7, 6, c))
    _close_per_basis(envelope(_t(r), c)[:, None].numpy(),
                     np.asarray(j_bessel.envelope(jnp.asarray(r), c))[:, None])
    ang = np.linspace(0.0, np.pi, 33).astype(np.float32)
    np.testing.assert_allclose(
        angular_basis(_t(ang), 7).numpy(),
        np.asarray(j_bessel.angular_basis(jnp.asarray(ang), 7)), rtol=0,
        atol=FP32_ATOL)
    for l in range(7):
        x = np.linspace(max(l / 2, 0.1), 20.0, 64).astype(np.float32)
        _close_per_basis(jl(l, _t(x))[:, None].numpy(),
                         np.asarray(j_bessel.jl(l, jnp.asarray(x)))[:, None])
    assert np.array_equal(bessel_zeros(6, 6), j_bessel.bessel_zeros(6, 6))
    x = np.linspace(0.0, 9.0, 50)
    for l in range(8):
        assert np.array_equal(_jl_np(l, x), j_bessel._jl_np(l, x))


def _constraint_rotations(cg_mod, path_list):
    """The three rotations ``clebsch_gordan`` draws for each path, from
    the module's own seed and ``_rand_rot``: (3·len(paths), 3, 3)."""
    out = []
    for l1, l2, l3 in path_list:
        rng = np.random.default_rng(hash((l1, l2, l3)) % (2 ** 32))
        out += [cg_mod._rand_rot(rng) for _ in range(3)]
    return np.stack(out)


def test_cg_paths_match_reference_bitwise():
    assert paths(2, 2, 2) == j_cg.paths(2, 2, 2)
    assert paths(6, 6, 6) == j_cg.paths(6, 6, 6)
    for l1, l2, l3 in paths(2, 2, 2):
        assert np.array_equal(clebsch_gordan(l1, l2, l3),
                              j_cg.clebsch_gordan(l1, l2, l3)), (l1, l2, l3)
    # every path up to l 6: the rotations drawn and the float64 blocks
    # its constraint matrix is built from (kron products of them)
    rots = _constraint_rotations(t_cg, paths(6, 6, 6))
    assert np.array_equal(rots, _constraint_rotations(j_cg, paths(6, 6, 6)))
    for a, b in zip(t_cg._wigner_d_np(rots, 6), j_cg._wigner_d_np(rots, 6)):
        assert np.array_equal(a, b)
    for forbidden in ((1, 1, 3), (0, 2, 1), (6, 0, 5)):
        assert np.array_equal(clebsch_gordan(*forbidden),
                              j_cg.clebsch_gordan(*forbidden))
