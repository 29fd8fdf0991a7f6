"""The port's mesh bodies outside the GNN ring against the JAX package's
own ``shard_map`` programs, on the CPU: the sharding rules
(``shard_tree``, ``with_sharding``), the production mesh
(``launch/mesh.py``), xDeepFM's row-sharded tables
(``embedding_bag.lookup_sharded``, ``xdeepfm.forward`` and
``retrieval_score`` over a mesh), ``moe_ffn(mesh=)`` and the LM over a
mesh (``forward``, ``prefill``, ``decode_step``, ``make_train_step``).

The reference runs once for the module, in a subprocess with four host
CPU devices (``tests/torch_mesh_ref.py models``), at S = 2 and 4 data
shards and on a (2, 2) grid over ("data", "model"); the port runs the
same meshes as ``Mesh(["cpu"] * n, ...)``.

- Bit for bit: the specs of ``shard_tree`` on the reference's own LM and
  GNN axes trees (and the production grid's), and ``lookup_sharded``.
- Within 1e-5 relative (fp32): ``forward`` and ``retrieval_score`` over a
  mesh; ``moe_ffn(mesh=)``'s output and aux loss, with each data shard's
  keep mask equal to the reference's; the LM's logits over a mesh.
- The reference's gaps (ROADMAP.md Queue 3), pinned: its sharded lookup
  reads zeros for an id outside ``[0, V)`` where its unsharded one clips;
  its ``moe_ffn`` needs a "model" axis.
"""
import pytest

pytest.importorskip("torch")

import pickle

import numpy as np
import torch

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax, recsys_params_from_jax
from repro_torch.launch.mesh import data_shards, make_production_mesh
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.models.recsys import embedding_bag as eb
from repro_torch.models.recsys import xdeepfm
from repro_torch.sharding import Mesh, NamedSharding, shard_tree, with_sharding
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from test_torch_mesh_ring import MESHES, mesh, rel, run_reference, subtree

RTOL = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("models", tmp_path_factory.mktemp("mesh_models"))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _shaped(tree):
    """The shapes tree with each (int, ...) leaf as a meta tensor."""
    if isinstance(tree, dict):
        return {k: _shaped(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shaped(v) for v in tree]
    return torch.empty(tree, device="meta")


def _jax_order(tree):
    """Leaves in ``jax.tree.leaves``' order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_order(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _jax_order(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b",
                                  "egnn"])
def test_shard_tree_specs_match_reference(ref, arch):
    """``shard_tree`` on the reference's own axes and shapes trees gives a
    ``NamedSharding`` a leaf whose spec is the reference's, at S = 2, 4 and
    (2, 2)."""
    axes, shapes = pickle.loads(ref["spec/trees"].tobytes())[arch]
    for name in MESHES:
        m = mesh(name)
        got = shard_tree(axes, _shaped(shapes), m)
        specs = _jax_order(got)
        assert all(isinstance(s, NamedSharding) and s.mesh is m
                   for s in specs)
        np.testing.assert_array_equal(
            np.array([repr(tuple(s.spec)) for s in specs]),
            ref[f"spec/{arch}/{name}"])


def test_production_mesh(ref):
    """The (16, 16) and (2, 16, 16) grids over the devices given, repeated
    in order; the production specs of DeepSeek-V2-Lite's tree are the
    reference's; no devices given means the CUDA devices."""
    m = make_production_mesh(devices=["cpu"])
    assert m.shape == {"data": 16, "model": 16} and data_shards(m) == 16
    pod = make_production_mesh(multi_pod=True, devices=["cpu", "cpu"])
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_shards(pod) == 32
    axes, shapes = pickle.loads(
        ref["spec/trees"].tobytes())["deepseek-v2-lite-16b"]
    got = _jax_order(shard_tree(axes, _shaped(shapes), m))
    np.testing.assert_array_equal(
        np.array([repr(tuple(s.spec)) for s in got]), ref["spec/dsv2/prod"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()
    else:
        assert make_production_mesh().devices[0, 0].type == "cuda"


def test_with_sharding_resolves_and_returns_its_input():
    x = torch.zeros((4, 8, 16))
    m = mesh("g22")
    assert with_sharding(x, ("batch", "seq", None), m) is x
    assert with_sharding(x, ("batch", "seq", None)) is x
    with pytest.raises(ValueError, match="rank"):
        with_sharding(x, ("batch", "seq", None, None), m)
    with pytest.raises(TypeError, match="Mesh"):
        with_sharding(x, ("batch",), object())


@pytest.mark.parametrize("name", list(MESHES))
def test_recsys_mesh_paths_match_reference(ref, name):
    """``lookup_sharded`` bit for bit (and ``forward(mesh=)`` equal to the
    port's unsharded forward bit for bit: each row is one row plus zeros);
    ``forward`` and ``retrieval_score`` over the mesh within 1e-5 of the
    reference's."""
    cfg = smoke_config("xdeepfm")
    params = recsys_params_from_jax(subtree(ref, "xdeepfm/params"), "cpu")
    ids = _t(ref["xdeepfm/ids"])
    m = mesh(name)
    got = eb.lookup_sharded(params["tables"], ids, m)
    np.testing.assert_array_equal(got.numpy(), ref[f"xdeepfm/lookup/{name}"])
    assert torch.equal(got, eb.lookup(params["tables"], ids))
    fwd = xdeepfm.forward(cfg, params, ids, m)
    assert torch.equal(fwd, xdeepfm.forward(cfg, params, ids))
    assert rel(fwd, ref[f"xdeepfm/forward/{name}"]) < RTOL
    score = xdeepfm.retrieval_score(cfg, params, ids[0], ids, m)
    assert rel(score, ref[f"xdeepfm/retrieval/{name}"]) < RTOL
    assert rel(score, xdeepfm.retrieval_score(cfg, params, ids[0], ids)) \
        < RTOL
    loss, aux = xdeepfm.loss_fn(cfg, params, {"ids": ids,
                                              "labels": ids[:, 0] % 2}, m)
    assert torch.isfinite(loss) and 0.0 <= float(aux["acc"]) <= 1.0


@pytest.mark.parametrize("name", ["s2", "g22"])
def test_sharded_lookup_reads_zeros_out_of_range(ref, name):
    """The reference's gap, kept: an id >= V or < 0 reads zeros through
    the row-sharded lookup, where ``lookup`` clips it into the table."""
    params = recsys_params_from_jax(subtree(ref, "xdeepfm/params"), "cpu")
    bad = _t(ref["xdeepfm/bad_ids"])
    got = eb.lookup_sharded(params["tables"], bad, mesh(name))
    np.testing.assert_array_equal(got.numpy(),
                                  ref[f"xdeepfm/lookup_bad/{name}"])
    assert float(got[0, 0].abs().max()) == 0.0
    assert float(got[1, 1].abs().max()) == 0.0
    clipped = eb.lookup(params["tables"], bad)
    np.testing.assert_array_equal(clipped.numpy(), ref["xdeepfm/lookup_bad"])
    assert float(clipped[0, 0].abs().max()) > 0.0


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_over_a_mesh_matches_reference(ref, name):
    """``moe_ffn(mesh=)`` at a capacity that overflows (cf 0.75): each data
    shard drops the reference's assignments (keep masks equal), and the
    output and aux loss are within 1e-5 of the reference's."""
    cfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    p = {k: _t(v) for k, v in subtree(ref, "moe/params").items()}
    x = _t(ref["moe/x"])
    routings = []
    out, aux = moe.moe_ffn(cfg, p, x, mesh(name), capacity_factor=0.75,
                           routings=routings)
    keep = np.stack([r.keep.numpy() for r in routings])
    np.testing.assert_array_equal(keep, ref[f"moe/{name}/keep"])
    assert float((out - _t(ref[f"moe/{name}/out"])).abs().max()) < RTOL
    assert abs(float(aux) - float(ref[f"moe/{name}/aux"])) < RTOL
    if MESHES[name][0] > 1:          # other drops than one unsharded call
        assert not np.array_equal(ref[f"moe/{name}/out"],
                                  ref["moe/none/out"])


def test_moe_without_model_axis_takes_the_intent(ref):
    """The reference's ``moe_ffn`` raises on a mesh without a "model" axis;
    the port runs it without a tensor-parallel split: the (2, 1) grid's
    result. Batch 1 (decode) is replicated over the data shards."""
    assert str(ref["raises/moe_data_only"]).startswith("ValueError")
    cfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    p = {k: _t(v) for k, v in subtree(ref, "moe/params").items()}
    x = _t(ref["moe/x"])
    out, _ = moe.moe_ffn(cfg, p, x, Mesh(["cpu"] * 2, ("data",)),
                         capacity_factor=0.75)
    assert float((out - _t(ref["moe/s2/out"])).abs().max()) < RTOL
    one, _ = moe.moe_ffn(cfg, p, x[:1], mesh("g22"))
    alone, _ = moe.moe_ffn(cfg, p, x[:1])
    assert float((one - alone).abs().max()) < RTOL


def test_lm_over_a_mesh_matches_reference(ref):
    """DeepSeek-V2-Lite's smoke config (MLA, MoE) in fp32 on the (2, 2)
    grid: ``forward`` logits and aux, ``prefill``'s last logits and one
    ``decode_step`` within 1e-5 of the reference's over the same mesh."""
    cfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    params = lm_params_from_jax(subtree(ref, "lm/params"), "cpu")
    tokens = _t(ref["lm/tokens"])
    m = mesh("g22")
    logits, aux = lm.forward(cfg, params, tokens, m)
    assert rel(logits, ref["lm/g22/logits"]) < RTOL
    assert abs(float(aux) - float(ref["lm/g22/aux"])) < RTOL
    last, cache = lm.prefill(cfg, params, tokens, 4, mesh=m)
    assert rel(last, ref["lm/g22/prefill"]) < RTOL
    nxt, _ = lm.decode_step(cfg, params, cache, tokens[:, 0], 16, mesh=m)
    assert rel(nxt, ref["lm/g22/decode"]) < RTOL


def test_lm_train_step_over_one_data_shard_equals_unsharded():
    """With one data shard the capacity is the unsharded one, so a step
    over a (1, 2) grid (the experts' F split over "model") gives the
    unsharded step's loss and parameters within 1e-5."""
    cfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    rng = np.random.default_rng(1)
    tok = _t(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    ocfg = AdamWConfig(lr=1e-3)
    runs = []
    for m in (None, Mesh(np.array(["cpu"] * 2).reshape(1, 2),
                         ("data", "model"))):
        params = lm.init_lm(cfg, 0, device="cpu")
        st = lm.make_train_step(cfg, m, opt_cfg=ocfg)
        params, _, metrics = st(params, init_adamw(params), batch)
        runs.append((params, metrics))
    (p0, m0), (p1, m1) = runs
    assert rel(m1["loss"], m0["loss"]) < RTOL
    for a, b in zip(leaves(p1), leaves(p0)):
        assert float((a - b).abs().max()) <= RTOL * max(1.0, float(
            b.abs().max()))
