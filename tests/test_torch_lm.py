"""The port's RAG LM (serving half) against the JAX package's ``lm``.

Both packages run the same parameters: the reference's ``init_lm`` output
carried over with ``convert.lm_params_from_jax``. Sizes are the reference's
``smoke_config("phi4-mini-3.8b")`` widths (2 layers, d 64, 4/2 heads) in
fp32, plus a ``sliding_window=32`` copy that exercises the SWA roll and a
QKV-bias config (qwen2's smoke widths).

Tolerance: logits 1e-4 absolute (fp32 sums in another order: one matmul
per projection here, XLA's einsums there), and the same argmax.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.layers.mlp import swiglu as j_swiglu
from repro.layers.norms import rms_norm as j_rms_norm
from repro.layers.rope import apply_rope as j_apply_rope
from repro.models import lm as jlm
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.layers.mlp import swiglu
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.models import lm

OPTS = jlm.ExecOpts(q_block=0, remat=False)
ATOL = 1e-4


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _pair(arch="phi4-mini-3.8b", **kw):
    jcfg = jsmoke(arch).replace(dtype="float32", **kw)
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, LMConfig(**dataclasses.asdict(jcfg)), pp


@pytest.fixture(scope="module")
def dense():
    return _pair()


def test_configs_match_reference():
    for arch in ("phi4-mini-3.8b",):
        j = jget_config(arch)
        p = get_config(arch)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.param_count() == j.param_count()
        assert p.resolved_head_dim == j.resolved_head_dim
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(jsmoke(arch))
    full = get_config("phi4-mini-3.8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == \
        (32, 3072, 24, 8, 128, 8192, 200064)
    assert full.tie_embeddings and full.dtype == "bfloat16"
    assert 3.7e9 < full.param_count() < 3.9e9


def test_init_lm_layout_and_count():
    cfg = smoke_config("phi4-mini-3.8b")
    p = lm.init_lm(cfg, seed=0, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert len(p["layers"]) == cfg.n_layers and "head" not in p
    assert tuple(p["layers"][0]["attn"]["wq"].shape) == (64, 4, 16)
    assert tuple(p["layers"][0]["attn"]["wo"].shape) == (4, 16, 64)
    n = sum(t.numel() for t in [p["embed"], p["final_ln"]]
            + [x for lp in p["layers"] for part in lp.values()
               for x in (part.values() if isinstance(part, dict) else [part])])
    assert n == cfg.param_count()
    assert lm.param_bytes(p) == 2 * n
    again = lm.init_lm(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["ffn"]["w2"],
                       p["layers"][1]["ffn"]["w2"])
    # std 1/sqrt(fan_in) before the bf16 cast
    std = float(lm.init_lm(cfg.replace(dtype="float32"), seed=1,
                           device="cpu")["embed"].std())
    assert abs(std - 1 / 8) < 0.01


def test_entry_points_need_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    cfg = smoke_config("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 2, 8)


@pytest.mark.parametrize("kw", [dict(attention="mla", kv_lora_rank=32),
                                dict(moe=True, n_experts=4, top_k=2)],
                         ids=["mla", "moe"])
def test_unported_layers_raise(kw):
    cfg = smoke_config("phi4-mini-3.8b").replace(**kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        lm.init_lm(cfg, device="cpu")


def test_bf16_params_carry_over_bit_for_bit():
    jcfg = jsmoke("phi4-mini-3.8b")
    params, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(3))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = pp["layers"][1]["attn"]["wk"]
    want = np.asarray(params["layers"]["attn"]["wk"][1]).view(np.uint16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)


def test_small_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(5)
    np.testing.assert_allclose(
        apply_rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=0, atol=1e-5)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    sc = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(h), _t(sc)).numpy(),
        np.asarray(j_rms_norm(jnp.asarray(h), jnp.asarray(sc))),
        rtol=0, atol=1e-5)
    w = {n: rng.normal(size=s).astype(np.float32) / 8
         for n, s in (("w1", (64, 32)), ("w3", (64, 32)), ("w2", (32, 64)))}
    np.testing.assert_allclose(
        swiglu({n: _t(a) for n, a in w.items()}, _t(h)).numpy(),
        np.asarray(j_swiglu({n: jnp.asarray(a) for n, a in w.items()},
                            jnp.asarray(h))),
        rtol=0, atol=1e-5)
    # bf16: the casts sit where the reference puts them
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        rms_norm(_t(h).to(torch.bfloat16), _t(sc)).float().numpy(),
        np.asarray(j_rms_norm(hb, jnp.asarray(sc)), np.float32))


def _check_logits(want, got):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _prefill_both(jcfg, jp, cfg, pp, toks, margin):
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks), None, OPTS,
                         margin=margin)
    pl, pc = lm.prefill(cfg, pp, _t(toks), margin=margin)
    _check_logits(jl, pl)
    for a, b in zip(jc, pc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)
    return jc, pc


@pytest.mark.parametrize("case", ["dense", "swa", "qkv_bias"])
def test_prefill_and_decode_match_reference(dense, case):
    """Prefill two prompts, then 6 decode steps at per-row positions
    (ragged: the rows start 3 apart). SWA: a 40-token prompt against a
    32-slot window, so prefill truncates and rolls and decode wraps."""
    if case == "dense":
        jcfg, jp, cfg, pp = dense
        s, margin = 11, 8
    elif case == "swa":
        jcfg, jp, cfg, pp = _pair(sliding_window=32)
        s, margin = 40, 8
    else:
        jcfg, jp, cfg, pp = _pair("qwen2-72b")
        assert cfg.qkv_bias
        s, margin = 9, 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jc, pc = _prefill_both(jcfg, jp, cfg, pp, toks, margin)
    pos = np.array([s, s - 3], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                 jnp.asarray(pos), None, OPTS)
        pl, pc2 = lm.decode_step(cfg, pp, pc, _t(tok), _t(pos))
        assert pc2 is pc                      # updated in place
        _check_logits(jl, pl)
        pos = pos + 1
    for a, b in zip(jc, pc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=ATOL)


def test_scalar_position_equals_vector(dense):
    _, _, cfg, pp = dense
    rng = np.random.default_rng(2)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 12)))
    nxt = _t(rng.integers(0, cfg.vocab_size, 2))
    _, c1 = lm.prefill(cfg, pp, toks, margin=4)
    _, c2 = lm.prefill(cfg, pp, toks, margin=4)
    ls, _ = lm.decode_step(cfg, pp, c1, nxt, 12)
    lv, _ = lm.decode_step(cfg, pp, c2, nxt, torch.tensor([12, 12]))
    assert torch.equal(ls, lv)


def test_init_cache_matches_reference(dense):
    jcfg, _, cfg, _ = dense
    jc, _ = jlm.init_cache(jcfg, 3, 16)
    pc = lm.init_cache(cfg, 3, 16, device="cpu")
    for a, b in zip(jc, pc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert lm.cache_len_for(cfg, 100) == jlm.cache_len_for(jcfg, 100)
    swa = cfg.replace(sliding_window=32)
    assert lm.cache_len_for(swa, 100) == 32
