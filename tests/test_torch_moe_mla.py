"""The port's MoE and MLA layers and the LM configs that use them, against
the JAX package.

- ``moe_ffn`` (out, aux) and its routing (top-k, the kept/dropped pattern)
  against ``repro.layers.moe.moe_ffn`` and the reference's routing lines,
  at ``smoke_config("deepseek-v2-lite-16b")`` widths in fp32, at the
  default capacity (drops) and at capacity factor 16 (none).
- ``mla_forward`` full and decode against ``repro.layers.mla``.
- The twins of ``tests/test_lm.py``'s ``test_prefill_matches_forward``,
  ``test_decode_matches_forward``, ``test_swa_rolling_cache_decode`` and
  ``test_param_count_matches_init`` for the MoE/MLA archs, on the port
  alone with its own seeded weights. The reference runs them in bf16 at
  0.02 (0.08 for MLA); the port's eager bf16 rounds every op's output,
  where XLA on the CPU keeps fused elementwise chains in fp32, and both of
  its bf16 paths land 0.02–0.055 from the fp32 result at smoke widths. So
  the twins run in fp32, where the identity they check (cache + decode
  = forward; absorbed MLA = materialised) holds to ``ATOL``.
- ``forward`` against the reference's for every LM config, the configs
  themselves, and a bf16 carry-over of the deepseek smoke parameters.

Inputs are numpy-seeded; weights cross with ``convert.lm_params_from_jax``.
Tolerances: fp32 outputs 1e-5 absolute (O(1) values, sums in another
order), logits ``ATOL`` 1e-4 as in ``test_torch_lm.py``. Routing is
compared exactly, except after a near-tie: XLA's and torch's fp32 router
matmuls may differ in the last bit, which can flip a token whose k-th and
(k+1)-th probabilities are within ``NEAR_TIE`` = 1e-6, and a flip moves
the capacity ranking of every later token. So the comparison stops at the
first near-tie token, with a warning that names it.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import math
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config, get_shapes as jget_shapes
from repro.configs import smoke_config as jsmoke
from repro.layers import mla as jmla
from repro.layers import moe as jmoe
from repro.models import lm as jlm
from repro_torch.configs import get_config, get_shapes, smoke_config
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.layers import mla, moe
from repro_torch.models import lm

OPTS = jlm.ExecOpts(q_block=0, remat=False)
LM_ARCHS = ("deepseek-67b", "qwen2-72b", "phi4-mini-3.8b", "mixtral-8x7b",
            "deepseek-v2-lite-16b")
MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-lite-16b")
ATOL = 1e-4
LAYER_ATOL = 1e-5
NEAR_TIE = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(arch, **kw):
    jcfg = jsmoke(arch).replace(dtype="float32", **kw)
    return jcfg, LMConfig(**dataclasses.asdict(jcfg))


def _np_params(rng, shapes):
    return {n: (rng.normal(size=s) / math.sqrt(fi)).astype(np.float32)
            for n, (s, fi) in shapes.items()}


def _ref_routing(cfg, wr, xf, cf):
    """The reference's routing lines (``repro/layers/moe.py``), in jnp."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(math.ceil(t * k * cf / e)), 1)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(wr), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    gap = srt[:, k - 1] - srt[:, k] if k < e else np.full(t, np.inf)
    return np.asarray(idx), np.asarray(pos < cap), gap


def _first_near_tie(gap) -> int:
    near = np.flatnonzero(gap < NEAR_TIE)
    if near.size:
        warnings.warn(f"router near-tie at token {near[0]} (gap "
                      f"{gap[near[0]]:.2e} < {NEAR_TIE}): routing and outputs "
                      "compared up to it only")
        return int(near[0])
    return len(gap)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_reference(arch):
    j, p = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    assert p.resolved_head_dim == j.resolved_head_dim
    assert [dataclasses.asdict(s) for s in get_shapes(arch)] == \
        [dataclasses.asdict(s) for s in jget_shapes(arch)]
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(jsmoke(arch))


def test_deepseek_v2_lite_fits_one_card():
    cfg = get_config("deepseek-v2-lite-16b")
    assert 15.6e9 < cfg.param_count() < 15.8e9          # 31.4 GB in bf16
    # 2.4 B active per token in the paper, which leaves out the embeddings
    assert 2.6e9 < cfg.active_param_count() < 2.7e9
    assert (cfg.n_layers, cfg.first_dense_layers, cfg.n_experts, cfg.top_k,
            cfg.n_shared_experts) == (27, 1, 64, 6, 2)


# --------------------------------------------------------------------- MoE
def _moe_case(cf, seed=0, t_shape=(2, 24)):
    """Tokens that share a component, as a layer's hidden states do, so
    that routing is skewed and the default capacity drops."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = _np_params(rng, {"wr": ((d, e), d), "w1": ((e, d, f), d),
                         "w3": ((e, d, f), d), "w2": ((e, f, d), f)})
    x = (rng.normal(size=t_shape + (d,))
         + 2.0 * rng.normal(size=(d,))).astype(np.float32)
    return jcfg, cfg, w, x


@pytest.mark.parametrize("cf", [1.25, 16.0], ids=["default_capacity", "cf16"])
def test_moe_ffn_matches_reference(cf):
    jcfg, cfg, w, x = _moe_case(cf)
    jout, jaux = jmoe.moe_ffn(jcfg, {n: jnp.asarray(a) for n, a in w.items()},
                              jnp.asarray(x), capacity_factor=cf)
    pw = {n: _t(a) for n, a in w.items()}
    routings = []
    pout, paux = moe.moe_ffn(cfg, pw, _t(x), capacity_factor=cf,
                             routings=routings)
    xf = x.reshape(-1, cfg.d_model)
    idx, keep, gap = _ref_routing(cfg, w["wr"], xf, cf)
    (r,) = routings
    n = _first_near_tie(gap)
    k = cfg.top_k
    np.testing.assert_array_equal(r.idx.numpy()[:n], idx[:n])
    np.testing.assert_array_equal(r.keep.numpy()[:n * k], keep[:n * k])
    if cf == 1.25 and n == len(gap):
        assert 0 < (~keep).sum() == int((~r.keep).sum())   # drops happen
    if cf == 16.0:
        assert keep.all()
    assert r.keep.shape == (xf.shape[0] * k,)
    assert float(moe.near_tie_gap(r)) == pytest.approx(gap.min(), abs=1e-6)
    np.testing.assert_allclose(pout.numpy().reshape(-1, cfg.d_model)[:n],
                               np.asarray(jout).reshape(-1, cfg.d_model)[:n],
                               rtol=0, atol=LAYER_ATOL)
    if n == len(gap):
        assert abs(float(paux) - float(jaux)) <= LAYER_ATOL
    # a dropped assignment contributes nothing: a token dropped by every
    # choice gets zero output
    none_kept = ~keep.reshape(-1, k)[:n].any(axis=1)
    assert np.all(pout.numpy().reshape(-1, cfg.d_model)[:n][none_kept] == 0)


def test_moe_dispatch_is_the_same_twice_and_refuses_a_mesh():
    _, cfg, w, x = _moe_case(1.25, seed=3)
    pw = {n: _t(a) for n, a in w.items()}
    a, _ = moe.moe_ffn(cfg, pw, _t(x))
    b, _ = moe.moe_ffn(cfg, pw, _t(x))
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Mesh"):
        moe.moe_ffn(cfg, pw, _t(x), mesh=object())


# --------------------------------------------------------------------- MLA
def _mla_params(cfg, rng):
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return _np_params(rng, {"wq": ((d, h, dn + dr), d), "w_dkv": ((d, r), d),
                            "w_krope": ((d, dr), d), "w_uk": ((r, h, dn), r),
                            "w_uv": ((r, h, dv), r),
                            "wo": ((h, dv, d), h * dv)})


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_mla_forward_matches_reference(mode):
    """full: a 13-token prompt (out and the (latent, k_rope) cache).
    decode: 3 rows at their own positions over a 16-slot cache holding
    ragged histories, the caches written in place."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    rng = np.random.default_rng(7)
    w = _mla_params(cfg, rng)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    pw = {n: _t(a) for n, a in w.items()}
    if mode == "full":
        x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
        pos = np.arange(13)
        jo, jc = jmla.mla_forward(jcfg, jw, jnp.asarray(x), jnp.asarray(pos),
                                  mode="full", q_block=0)
        po, pc = mla.mla_forward(cfg, pw, _t(x), _t(pos), mode="full")
    else:
        b, clen = 3, 16
        lens = np.array([5, 11, 15])
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        lat = rng.normal(size=(b, clen, cfg.kv_lora_rank)).astype(np.float32)
        rope = rng.normal(size=(b, clen, cfg.qk_rope_head_dim)).astype(np.float32)
        slot_pos = np.where(np.arange(clen)[None] < lens[:, None],
                            np.arange(clen)[None], -(10 ** 9)).astype(np.int32)
        jo, jc = jmla.mla_forward(
            jcfg, jw, jnp.asarray(x), jnp.asarray(lens[:, None]), mode="decode",
            cache=(jnp.asarray(lat), jnp.asarray(rope), jnp.asarray(slot_pos)),
            cache_pos=jnp.asarray(lens.astype(np.int32)))
        pcache = (_t(lat), _t(rope), _t(slot_pos))
        po, pc = mla.mla_forward(cfg, pw, _t(x), _t(lens[:, None]),
                                 mode="decode", cache=pcache,
                                 cache_pos=_t(lens.astype(np.int32)))
        assert all(a is b for a, b in zip(pc, pcache))      # in place
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0,
                               atol=LAYER_ATOL)
    for a, c in zip(jc, pc):
        assert tuple(c.shape) == a.shape
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=0,
                                   atol=LAYER_ATOL)


# ---------------------------------------------- twins of tests/test_lm.py
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_matches_forward(arch):
    cfg = smoke_config(arch).replace(dtype="float32")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    toks = _t(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    lf, _ = lm.forward(cfg, params, toks)
    lp, _ = lm.prefill(cfg, params, toks)
    np.testing.assert_allclose(lf[:, -1].numpy(), lp.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    cfg = smoke_config(arch).replace(capacity_factor=16.0,  # no MoE drops
                                     dtype="float32")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 12)))
    _, cache = lm.prefill(cfg, params, toks, margin=4)
    nxt = _t(rng.integers(0, cfg.vocab_size, 2))
    l13, _ = lm.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1))
    ld, _ = lm.decode_step(cfg, params, cache, nxt, 12)
    np.testing.assert_allclose(l13[:, -1].numpy(), ld.numpy(), rtol=0,
                               atol=ATOL)


def test_swa_rolling_cache_decode():
    cfg = smoke_config("mixtral-8x7b").replace(capacity_factor=16.0,
                                               dtype="float32")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(0, cfg.vocab_size, (1, 40)))
    _, cache = lm.prefill(cfg, params, toks)
    assert cache[0].shape[2] == cfg.sliding_window          # rolled to window
    nxt = _t(rng.integers(0, cfg.vocab_size, 1))
    l41, _ = lm.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1))
    ld, _ = lm.decode_step(cfg, params, cache, nxt, 40)
    np.testing.assert_allclose(l41[:, -1].numpy(), ld.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_count_matches_init(arch):
    cfg = smoke_config(arch)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    leaves = [params["embed"], params["final_ln"]] + (
        [params["head"]] if "head" in params else [])
    for lp in params["layers"]:
        for part in lp.values():
            leaves += list(part.values()) if isinstance(part, dict) else [part]
    assert sum(t.numel() for t in leaves) == cfg.param_count()   # exact
    routers = [t for t in leaves if t.dtype == torch.float32]
    assert len(routers) == (cfg.n_layers - cfg.first_dense_layers
                            if cfg.moe else 0)             # fp32 wr only


# ------------------------------------------- forward against the reference
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    """Logits of a 2 × 12 prompt and the aux loss, same weights, fp32."""
    jcfg, cfg = _cfgs(arch)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    jl, ja = jlm.forward(jcfg, jp, jnp.asarray(toks), None, OPTS)
    routings = []
    pl, pa = lm.forward(cfg, pp, _t(toks), moe_routings=routings)
    if any(float(moe.near_tie_gap(r)) < NEAR_TIE for r in routings):
        warnings.warn(f"{arch}: router near-tie, logits not compared")
        return
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert abs(float(pa) - float(ja)) <= LAYER_ATOL
    assert len(routings) == (cfg.n_layers - cfg.first_dense_layers
                          if cfg.moe else 0)


def test_bf16_params_carry_over_bit_for_bit():
    """deepseek smoke (a dense head layer, MLA, MoE with a shared expert):
    every leaf of the reference's params, the fp32 router included."""
    jcfg = jsmoke("deepseek-v2-lite-16b")
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    pp = lm_params_from_jax(tree, device="cpu")
    jlayers = tree["head_layers"] + [
        jax.tree.map(lambda a, i=i: a[i], tree["layers"])
        for i in range(jcfg.n_layers - jcfg.first_dense_layers)]
    assert len(pp["layers"]) == len(jlayers) == jcfg.n_layers
    assert "ffn" in pp["layers"][0] and "moe" in pp["layers"][1]

    def same(a, t):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            return np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))
        assert t.dtype == torch.float32
        return np.array_equal(t.numpy(), a)

    for jl, pl in zip(jlayers, pp["layers"]):
        for part, leaves in jl.items():
            if isinstance(leaves, dict):
                for name, a in leaves.items():
                    assert same(a, pl[part][name]), (part, name)
            else:
                assert same(leaves, pl[part]), part
    for name in ("embed", "head", "final_ln"):
        assert same(tree[name], pp[name]), name
