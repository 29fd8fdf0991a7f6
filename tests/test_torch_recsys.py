"""The port's recsys slice (xDeepFM) against the JAX package's, on the CPU.

Both sides get the same inputs, made from a numpy seed, and the same
weights (the reference's ``xdeepfm.init``, carried over by
``convert.recsys_params_from_jax``). On the CPU the port's table
transposes run the in-place kernel's plain version and ``embedding_bag``'s
sums the segment-sum kernel's; the reference differentiates ``jnp.take``
and sums with ``jax.ops.segment_sum``.

- The config, its smoke config, its shapes and the registry's 40 cells
  equal the reference's.
- ``lookup`` and ``embedding_bag`` (sum, mean, max) with ids < 0 and >= V
  and an empty bag: max |Δ| ≤ 1e-6.
- ``forward``, ``loss_fn`` and its accuracy, gradients against
  ``jax.grad`` (repeated and clipped ids), one AdamW step against the
  reference's ``adamw_update``, and ``retrieval_score``, at the smoke
  config and at full width (39 fields, D 10, CIN 3 x 200, MLP 2 x 400)
  over 64 rows: max |Δ| ≤ 1e-5 · max |want| of each leaf (fp32 matmuls
  and sums in another order), to max(1, max |want|) for the new params,
  as ``test_torch_train.py`` holds them (Adam's first step is ±lr·g/(|g| +
  eps), so a bias whose gradient is near eps moves by a share of lr).
- The chunked CIN equals one chunk, forward and backward; twins of
  ``tests/test_infra.py::TestRecsys``; the mesh paths refuse a mesh that
  is not a ``Mesh``.
"""
import pytest

pytest.importorskip("torch")

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro import configs as j_configs
from repro.models.recsys import embedding_bag as j_eb
from repro.models.recsys import xdeepfm as j_x
from repro.train import optimizer as j_opt
from repro_torch import configs as t_configs
from repro_torch.common.tree import leaves
from repro_torch.configs.base import RecsysConfig, ShapeSpec
from repro_torch.convert import recsys_params_from_jax
from repro_torch.data.pipeline import SyntheticRecsysStream
from repro_torch.models.recsys import embedding_bag as t_eb
from repro_torch.models.recsys import xdeepfm as t_x
from repro_torch.train import optimizer as t_opt

_CFGS = {"smoke": j_configs.smoke_config, "full": j_configs.get_config}


def _close(got, want, rtol: float = 1e-5, name: str = "",
           floor: float = 1e-30) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    tol = rtol * max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max |d| {err} > {tol}"


@pytest.fixture(scope="module", params=["smoke", "full"])
def model(request):
    """(name, reference config, port config, reference params, port
    params): the reference's weights at that config, carried over."""
    jcfg = _CFGS[request.param]("xdeepfm")
    tcfg = RecsysConfig(**dataclasses.asdict(jcfg))
    jp, _ = j_x.init(jcfg, jax.random.PRNGKey(3))
    tp = recsys_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _ids(cfg, rows: int, seed: int) -> np.ndarray:
    """(rows, F) ids with repeats, ids < 0 and ids >= V."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_per_field, (rows, cfg.n_sparse))
    ids[: rows // 2, 0] = 5                      # one row read by many
    ids[1, 1], ids[2, 2] = -3, cfg.vocab_per_field + 7
    ids[3, :] = ids[4, :]                        # a repeated row
    return ids.astype(np.int32)


def _batch(cfg, rows: int, seed: int):
    ids = _ids(cfg, rows, seed)
    y = np.random.default_rng(seed + 1).integers(0, 2, rows).astype(np.int32)
    return ({"ids": jnp.asarray(ids), "labels": jnp.asarray(y)},
            {"ids": torch.from_numpy(ids), "labels": torch.from_numpy(y)})


# ------------------------------------------------------------------ configs
def test_config_and_shapes_match_reference():
    ref = j_configs.get_config("xdeepfm")
    cfg = t_configs.get_config("xdeepfm")
    assert RecsysConfig(**dataclasses.asdict(ref)) == cfg
    assert (RecsysConfig(**dataclasses.asdict(j_configs.smoke_config(
        "xdeepfm"))) == t_configs.smoke_config("xdeepfm"))
    assert cfg.param_count() == ref.param_count() == 42_742_001
    assert ([dataclasses.asdict(s) for s in t_configs.get_shapes("xdeepfm")]
            == [dataclasses.asdict(s) for s in j_configs.get_shapes("xdeepfm")])
    assert t_configs.get_shapes("xdeepfm")[2]["batch"] == 262_144


@pytest.mark.parametrize("include_skipped", [True, False])
def test_all_cells_match_reference(include_skipped):
    got = [(a, dataclasses.asdict(s))
           for a, s in t_configs.all_cells(include_skipped)]
    want = [(a, dataclasses.asdict(s))
            for a, s in j_configs.all_cells(include_skipped)]
    assert got == want
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    if include_skipped:
        assert len(got) == 40
    assert all(isinstance(s, ShapeSpec)
               for _, s in t_configs.all_cells(include_skipped))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="no-such-arch"):
        t_configs.get_config("no-such-arch")


# ------------------------------------------------------------ embedding bag
def test_lookup_matches_reference():
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(5, 11, 3)).astype(np.float32)
    ids = rng.integers(-4, 16, (9, 5)).astype(np.int32)
    want = j_eb.lookup(jnp.asarray(tables), jnp.asarray(ids))
    got = t_eb.lookup(torch.from_numpy(tables), torch.from_numpy(ids))
    _close(got, want, 1e-6, "lookup")


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(1)
    tables = rng.normal(size=(3, 20, 4)).astype(np.float32)
    n_bags = 7
    flat = rng.integers(-3, 25, 40).astype(np.int32)   # < 0 and >= V
    bags = rng.integers(0, n_bags, 40).astype(np.int32)
    bags[bags == 4] = 5                                 # bag 4 is empty
    for field in (0, 2):
        want = np.asarray(j_eb.embedding_bag(
            jnp.asarray(tables), jnp.asarray(flat), jnp.asarray(bags),
            n_bags, field, mode))
        got = t_eb.embedding_bag(torch.from_numpy(tables),
                                 torch.from_numpy(flat),
                                 torch.from_numpy(bags), n_bags, field, mode)
        fin = np.isfinite(want)
        assert (fin == np.isfinite(got.numpy())).all()
        # the empty bag: -inf under max, 0 otherwise
        if mode == "max":
            assert not fin[4].any() and fin[np.arange(n_bags) != 4].all()
        else:
            assert fin.all() and not got[4].any()
        _close(np.where(fin, got.numpy(), 0), np.where(fin, want, 0), 1e-6,
               f"{mode} field {field}")
    with pytest.raises(ValueError):
        t_eb.embedding_bag(torch.from_numpy(tables), torch.from_numpy(flat),
                           torch.from_numpy(bags), n_bags, 0, "min")


def test_embedding_bag_sum_gradient_matches_reference():
    rng = np.random.default_rng(2)
    tables = rng.normal(size=(2, 10, 3)).astype(np.float32)
    flat = np.array([0, 3, 3, -1, 12, 9, 3, 0], np.int32)
    bags = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    cot = rng.normal(size=(4, 3)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(j_eb.embedding_bag(
        t, jnp.asarray(flat), jnp.asarray(bags), 4, 1) * cot))(
            jnp.asarray(tables))
    t = torch.from_numpy(tables).requires_grad_(True)
    (t_eb.embedding_bag(t, torch.from_numpy(flat), torch.from_numpy(bags),
                        4, 1) * torch.from_numpy(cot)).sum().backward()
    _close(t.grad, want, 1e-6, "d tables")


# ------------------------------------------------------------------ xDeepFM
def test_forward_loss_and_acc_match_reference(model):
    name, jcfg, tcfg, jp, tp = model
    jb, tb = _batch(tcfg, 64, 7)
    want = j_x.forward(jcfg, jp, jb["ids"])
    got = t_x.forward(tcfg, tp, tb["ids"])
    _close(got, want, 1e-5, f"{name} logits")
    jl, jaux = j_x.loss_fn(jcfg, jp, jb)
    tl, taux = t_x.loss_fn(tcfg, tp, tb)
    _close(tl, jl, 1e-5, f"{name} loss")
    assert float(taux["acc"]) == float(jaux["acc"])


def test_gradients_match_reference(model):
    name, jcfg, tcfg, jp, tp = model
    jb, tb = _batch(tcfg, 64, 8)
    want = jax.grad(lambda p: j_x.loss_fn(jcfg, p, jb)[0])(jp)
    live = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = t_x.loss_fn(tcfg, live, tb)
    grads = torch.autograd.grad(loss, leaves(live))
    assert len(grads) == len(want)
    for k, g in zip(sorted(live), grads):
        _close(g, want[k], 1e-5, f"{name} d{k}")
    # the clipped ids' gradients land on the clamped rows
    v = tcfg.vocab_per_field
    assert float(np.abs(np.asarray(want["tables"])[1, 0]).max()) > 0
    assert float(np.abs(np.asarray(want["tables"])[2, v - 1]).max()) > 0


def test_adamw_step_matches_reference(model):
    name, jcfg, tcfg, jp, tp = model
    jb, tb = _batch(tcfg, 64, 9)
    jo = j_opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    to = t_opt.AdamWConfig(**dataclasses.asdict(jo))

    @jax.jit
    def j_step(params, opt, batch):
        (l, aux), g = jax.value_and_grad(
            lambda p: j_x.loss_fn(jcfg, p, batch), has_aux=True)(params)
        params, opt, om = j_opt.adamw_update(jo, g, opt, params)
        return params, opt, {"loss": l, **aux, **om}

    jnew, jstate, jm = j_step(jp, j_opt.init_adamw(jp), jb)
    step = t_x.make_train_step(tcfg, to)
    tnew, tstate, tm = step(tp, t_opt.init_adamw(tp), tb)
    assert set(tm) == set(jm)
    for k in ("loss", "grad_norm", "lr"):
        _close(tm[k], jm[k], 1e-5, f"{name} {k}")
    assert int(tstate.step) == int(jstate.step) == 1
    for k in sorted(tp):
        _close(tnew[k], jnew[k], 1e-5, f"{name} new {k}", floor=1.0)
        _close(tstate.mu[k], jstate.mu[k], 1e-5, f"{name} mu {k}")
        _close(tstate.nu[k], jstate.nu[k], 1e-5, f"{name} nu {k}")
    # the step returns new trees and leaves its inputs as they were
    np.testing.assert_array_equal(tp["bias"].numpy(), np.asarray(jp["bias"]))


def test_retrieval_score_matches_reference(model):
    name, jcfg, tcfg, jp, tp = model
    ids = _ids(tcfg, 33, 10)
    want = j_x.retrieval_score(jcfg, jp, jnp.asarray(ids[0]),
                               jnp.asarray(ids[1:]))
    got = t_x.retrieval_score(tcfg, tp, torch.from_numpy(ids[0]),
                              torch.from_numpy(ids[1:]))
    _close(got, want, 1e-5, f"{name} scores")


@pytest.mark.parametrize("chunk_rows", [1, 7, 64])
def test_chunked_cin_equals_one_chunk(chunk_rows, monkeypatch):
    cfg = t_configs.get_config("xdeepfm")
    params = t_x.init(cfg.replace(vocab_per_field=16), 0, device="cpu")
    x0 = torch.randn((50, cfg.n_sparse, cfg.embed_dim),
                     generator=torch.Generator().manual_seed(0))
    n = len(cfg.cin_layers)
    ws = {f"cin_w{k}": params[f"cin_w{k}"].clone().requires_grad_(True)
          for k in range(n)}
    xg = x0.clone().requires_grad_(True)
    cot = torch.randn((50, sum(cfg.cin_layers)),
                      generator=torch.Generator().manual_seed(1))
    outs, grads = {}, {}
    for c in (1 << 20, chunk_rows):
        monkeypatch.setattr(t_x, "CIN_CHUNK_ROWS", c)
        with torch.no_grad():
            outs[c] = t_x.cin(params, x0, n)
        # under grad each chunk is checkpointed
        out = t_x.cin(ws, xg, n)
        _close(out, outs[c].numpy(), 0.0, f"cin at {c} rows, under grad")
        grads[c] = torch.autograd.grad((out * cot).sum(),
                                       [xg, *ws.values()])
    _close(outs[chunk_rows], outs[1 << 20].numpy(), 1e-6, "cin")
    for a, b in zip(grads[chunk_rows], grads[1 << 20]):
        _close(a, b.numpy(), 1e-6, "cin grad")


def test_xdeepfm_trains():
    """Twin of ``test_infra.py::TestRecsys::test_xdeepfm_trains``."""
    cfg = t_configs.smoke_config("xdeepfm")
    params = t_x.init(cfg, 0, device="cpu")
    opt = t_opt.init_adamw(params)
    stream = SyntheticRecsysStream(cfg.n_sparse, cfg.vocab_per_field, 64)
    step = t_x.make_train_step(cfg, t_opt.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=50))
    first = None
    for i in range(25):
        b = {k: torch.from_numpy(v) for k, v in stream.batch_at(i).items()}
        params, opt, m = step(params, opt, b)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first


def test_retrieval_ranks_similar_user_higher():
    """Twin of ``TestRecsys::test_retrieval_ranks_similar_user_higher``."""
    cfg = t_configs.smoke_config("xdeepfm")
    params = t_x.init(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    user = rng.integers(0, cfg.vocab_per_field, cfg.n_sparse).astype(np.int32)
    cands = rng.integers(0, cfg.vocab_per_field,
                         (64, cfg.n_sparse)).astype(np.int32)
    cands[0] = user   # identical item should score max
    s = t_x.retrieval_score(cfg, params, torch.from_numpy(user),
                            torch.from_numpy(cands))
    assert int(torch.argmax(s)) == 0


def test_mesh_paths_refuse_naming_step_11():
    """Named for what it checked before the mesh paths were ported: they
    now run (``tests/test_torch_mesh_models.py``), and refuse a mesh that
    is not a ``Mesh``."""
    cfg = t_configs.smoke_config("xdeepfm")
    params = t_x.init(cfg, 0, device="cpu")
    ids = torch.zeros((2, cfg.n_sparse), dtype=torch.int32)
    mesh = object()
    for call in (lambda: t_x.forward(cfg, params, ids, mesh),
                 lambda: t_x.loss_fn(cfg, params, {"ids": ids,
                                                   "labels": ids[:, 0]}, mesh),
                 lambda: t_x.retrieval_score(cfg, params, ids[0], ids, mesh),
                 lambda: t_eb.lookup_sharded(params["tables"], ids, mesh)):
        with pytest.raises(TypeError, match="Mesh"):
            call()


def test_init_matches_reference_layout():
    """Same leaves, shapes and dtypes as the reference's tree, on the
    device asked for; the same seed gives the same draws."""
    cfg = t_configs.smoke_config("xdeepfm")
    jp, _ = j_x.init(j_configs.smoke_config("xdeepfm"), jax.random.PRNGKey(0))
    tp = t_x.init(cfg, 0, device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
    again = t_x.init(cfg, 0, device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)
