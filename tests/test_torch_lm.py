"""The port's RAG LM (serving half) against the JAX package's ``lm``.

Both packages run the same parameters: the reference's ``init_lm`` output
carried over with ``convert.lm_params_from_jax``. Sizes are the reference's
``smoke_config("phi4-mini-3.8b")`` widths (2 layers, d 64, 4/2 heads) in
fp32, plus a ``sliding_window=32`` copy that exercises the SWA roll, a
QKV-bias config (qwen2's smoke widths), and the MoE/MLA configs:
deepseek-v2-lite (MLA, a dense first layer, a shared expert) at capacity
factor 16 and at its default 1.25 (capacity drops included), and mixtral
(top-2 MoE behind a 32-slot window).

Tolerance: logits 1e-4 absolute (fp32 sums in another order: one matmul
per projection here, XLA's einsums there), and the same argmax. MoE
routing can flip where a token's k-th and (k+1)-th router probabilities
are within 1e-6 (the fp32 router matmuls differ in the last bit); a step
whose routing (``moe_routings``) shows such a near-tie is not compared, and
the test says so with a warning.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.layers.mlp import swiglu as j_swiglu
from repro.layers.norms import rms_norm as j_rms_norm
from repro.layers.rope import apply_rope as j_apply_rope
from repro.models import lm as jlm
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.layers import moe
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
    """Reference and port configs and parameters (fp32, the reference's
    weights carried over)."""
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
def test_mla_and_moe_layers_init_and_decode_on_cpu(kw):
    """The layer kinds the port once refused: a phi4-mini smoke config
    with MLA (the default 128/64/128 head widths) or a top-2 MoE FFN
    builds its layout, prefills, and decodes two steps to finite logits
    of the right shape; the MLA cache holds (latent, roped k)."""
    cfg = smoke_config("phi4-mini-3.8b").replace(**kw)
    p = lm.init_lm(cfg, seed=0, device="cpu")
    lp = p["layers"][0]
    if cfg.attention == "mla":
        assert set(lp["attn"]) == {"wq", "w_dkv", "w_krope", "w_uk", "w_uv",
                                   "wo"}
    else:
        assert set(lp) == {"attn", "ln1", "ln2", "moe"}
        assert lp["moe"]["wr"].dtype == torch.float32
    toks = torch.arange(10)[None].repeat(2, 1) % cfg.vocab_size
    logits, cache = lm.prefill(cfg, p, toks, margin=2)
    want = lm.init_cache(cfg, 2, 12, device="cpu")
    assert [tuple(c.shape) for c in cache] == [tuple(c.shape) for c in want]
    if cfg.attention == "mla":
        assert cache[0].shape[-1] == 32 and cache[1].shape[-1] == 64
    for pos in (10, 11):
        logits, cache = lm.decode_step(cfg, p, cache, torch.tensor([3, 4]),
                                       pos)
        assert tuple(logits.shape) == (2, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())


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


def _near_tie(routings, what) -> bool:
    tie = any(float(moe.near_tie_gap(r)) < 1e-6 for r in routings)
    if tie:
        warnings.warn(f"{what}: MoE router near-tie (< 1e-6), logits not "
                      "compared")
    return tie


@pytest.mark.parametrize("case", ["dense", "swa", "qkv_bias", "mla",
                                  "moe_swa", "moe_default_capacity"])
def test_prefill_and_decode_match_reference(dense, case):
    """Prefill two prompts, then 6 decode steps at per-row positions
    (ragged: the rows start 3 apart). SWA: a 40-token prompt against a
    32-slot window, so prefill truncates and rolls and decode wraps; the
    MoE cases route the two rows of a step together, so their drops at
    the default capacity depend on both."""
    s, margin = 11, 8
    if case == "dense":
        jcfg, jp, cfg, pp = dense
    elif case == "swa":
        jcfg, jp, cfg, pp = _pair(sliding_window=32)
        s = 40
    elif case == "qkv_bias":
        jcfg, jp, cfg, pp = _pair("qwen2-72b")
        assert cfg.qkv_bias
        s = 9
    elif case == "mla":
        jcfg, jp, cfg, pp = _pair("deepseek-v2-lite-16b", capacity_factor=16.0)
        assert cfg.attention == "mla" and cfg.first_dense_layers == 1
    elif case == "moe_swa":
        jcfg, jp, cfg, pp = _pair("mixtral-8x7b")
        assert cfg.moe and cfg.sliding_window == 32
        s = 40
    else:
        jcfg, jp, cfg, pp = _pair("deepseek-v2-lite-16b")
        assert cfg.capacity_factor == 1.25
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    routings = []
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks), None, OPTS,
                         margin=margin)
    pl, pc = lm.prefill(cfg, pp, _t(toks), margin=margin,
                        moe_routings=routings)
    tie = _near_tie(routings, f"{case} prefill")
    if not tie:
        _check_logits(jl, pl)
    for a, b in zip(jc, pc):
        assert tuple(b.shape) == a.shape
        if not tie:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=ATOL)
    dropped = sum(int((~r.keep).sum()) for r in routings)
    pos = np.array([s, s - 3], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                 jnp.asarray(pos), None, OPTS)
        routings = []
        pl, pc2 = lm.decode_step(cfg, pp, pc, _t(tok), _t(pos),
                                 moe_routings=routings)
        assert pc2 is pc                      # updated in place
        tie = tie or _near_tie(routings, f"{case} decode")
        if not tie:
            _check_logits(jl, pl)
        dropped += sum(int((~r.keep).sum()) for r in routings)
        pos = pos + 1
    if case == "moe_default_capacity":
        assert dropped > 0                    # the case exercises drops
    if case == "mla":
        assert dropped == 0                   # capacity factor 16
    if tie:
        return
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
