"""DimeNet at its published config on the molecule cell's molecules
(128 graphs x 30 nodes x 64 edges, seed 0), the port against the JAX
package's, on the CPU.

Unit-sphere atoms can sit close together, where the spherical Bessel j_l
(l <= 6, an upward recurrence) loses fp32's digits at z·r/c < l/2: the
reference's own logits then move far beyond ``tests/test_gnn.py``'s 1e-4
when the molecules are rotated, while the port's same function in
float64 stays within it, so the spread is fp32 rounding, amplified. With
the bonds spread (``driver.spread_bonds``: 1.7 to 4.8 long) both stay
within 1e-4 and the port's logits match the reference's within 1e-5 ·
max(1, max |want|).
"""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models.gnn import dimenet as j_dimenet
from repro.models.gnn import driver as jd
from repro.models.gnn.common import FlatGraph as JFlatGraph
from repro_torch.common.tree import tree_map
from repro_torch.configs import get_config
from repro_torch.convert import gnn_params_from_jax
from repro_torch.models.gnn import dimenet as t_dimenet
from repro_torch.models.gnn import driver as td
from repro_torch.models.gnn.common import FlatGraph

ROT_RTOL = 1e-4


def _rotation() -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@pytest.fixture(scope="module")
def molecules():
    """(reference params, port params, the molecule cell's batch, the
    reference's jitted per-molecule logits)."""
    jc = j_get_config("dimenet")
    params, _ = jd.init_model(jc, jax.random.PRNGKey(0), 4, 1)
    tp = gnn_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    mb, _ = td.make_molecule_batch(128, 30, 64, seed=0, device="cpu")
    logits = jax.jit(jax.vmap(
        lambda g, t: jd.node_logits_local(jc, params, g, t)))
    return tp, mb, logits


def _reference(logits, mb: FlatGraph, trip, positions) -> np.ndarray:
    g = JFlatGraph(*(jnp.asarray(x.numpy()) for x in mb))
    t = j_dimenet.TripletIndex(*(jnp.asarray(x.numpy()) for x in trip))
    return np.asarray(logits(g._replace(positions=jnp.asarray(positions)),
                             t)).reshape(-1, 1)


def _port(params, mb: FlatGraph, trip, positions) -> torch.Tensor:
    u = td.disjoint_union(mb._replace(positions=positions))
    with torch.no_grad():
        return td.node_logits_local(get_config("dimenet"), params, u,
                                    td.union_triplets(trip, 64))


def _moved(a, b) -> float:
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _trip(mb: FlatGraph):
    return t_dimenet.build_batch_triplets(
        *(x.numpy() for x in (mb.edge_src, mb.edge_dst, mb.edge_mask)),
        device="cpu")


def test_unit_sphere_rotation_error_is_the_references(molecules):
    tp, mb, logits = molecules
    trip = _trip(mb)
    rotated = mb.positions @ torch.from_numpy(_rotation().T.astype(np.float32))
    ref = _moved(_reference(logits, mb, trip, mb.positions.numpy()),
                 _reference(logits, mb, trip, rotated.numpy()))
    assert ref > ROT_RTOL, ref
    p64 = tree_map(lambda t: t.double(), tp)
    m64 = FlatGraph(*(x.double() if x.is_floating_point() else x
                      for x in mb))
    rot64 = m64.positions @ torch.from_numpy(_rotation().T)
    port64 = _moved(_port(p64, m64, trip, m64.positions).numpy(),
                    _port(p64, m64, trip, rot64).numpy())
    assert port64 <= ROT_RTOL, port64


def test_spread_bonds_match_reference_and_rotate(molecules):
    tp, mb, logits = molecules
    mb = td.spread_bonds(mb)
    trip = _trip(mb)
    rotated = mb.positions @ torch.from_numpy(_rotation().T.astype(np.float32))
    want = _reference(logits, mb, trip, mb.positions.numpy())
    got = _port(tp, mb, trip, mb.positions).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    assert _moved(want, _reference(logits, mb, trip,
                                   rotated.numpy())) <= ROT_RTOL
    assert _moved(got, _port(tp, mb, trip, rotated).numpy()) <= ROT_RTOL


def test_spread_bonds_keeps_bonds_in_the_stable_range(molecules):
    """Positions scaled, edges shorter than ``SPREAD_R_MIN`` masked and no
    edge unmasked, on a batch and on one graph."""
    _, mb, _ = molecules
    for g in (mb, td.make_flat_graph(60, 300, 8, seed=0, device="cpu")):
        s = td.spread_bonds(g)
        assert torch.equal(s.positions, g.positions * td.SPREAD_SCALE)
        assert not bool((s.edge_mask & ~g.edge_mask).any())
        b = g.edge_src.shape[0] if g.edge_src.dim() == 2 else None
        u = td.disjoint_union(s) if b else s
        rel = u.positions[u.edge_src.long()] - u.positions[u.edge_dst.long()]
        bond = torch.linalg.vector_norm(rel, dim=-1)
        kept = u.edge_mask
        assert bool((bond[kept] >= td.SPREAD_R_MIN).all())
        assert bool((bond[~kept & g.edge_mask.reshape(-1)]
                     < td.SPREAD_R_MIN).all())
        assert float(bond.max()) <= 2 * td.SPREAD_SCALE + 1e-5
        assert 0.8 < float(kept.float().mean()) < 0.95
