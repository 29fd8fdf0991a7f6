"""The port's flash-decode plain version and ``attend_decode`` against the
JAX package's.

On the CPU the port's ``decode_attention`` wrapper runs its plain version
(``kernels/decode_attention/ref.py``); the reference runs its Pallas kernel
in interpret mode (as ``tests/test_kernels.py`` does) and its own oracle.
The CUDA kernel itself is held against the plain version by the
``gpu``-marked cases of ``tests/test_torch_kernels_gpu.py``.

Tolerances: fp32 1e-5 absolute (the same fp32 sums in another order);
bf16 2e-2 relative (+ 2e-2 absolute near 0) — the two packages round the
bf16 inputs and the output the same way, but sum in another order.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax.numpy as jnp
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as j_ref
from repro.layers.attention import attend_decode as j_attend_decode
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.layers.attention import attend_decode


def _inputs(seed, b=4, s=96, hkv=2, g=3, hd=16, all_invalid_row=True):
    """Ragged valid rows (one full, one all-invalid unless told not to)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv * g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    lengths = rng.integers(1, s, b)
    valid = np.arange(s)[None, :] < lengths[:, None]
    valid[:, ::7] &= rng.random(s)[::7] > 0.5       # holes
    valid[-1] = True
    if all_invalid_row:
        valid[0] = False
    return q, k, v, valid


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


@pytest.mark.parametrize("g", [1, 3, 4])
def test_plain_version_matches_reference_fp32(g):
    q, k, v, valid = _inputs(0, g=g)
    b, h, hd = q.shape
    hkv = k.shape[2]
    want_kernel = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(valid),
                                      block_s=32))
    want_ref = np.asarray(j_ref(jnp.asarray(q).reshape(b, hkv, g, hd),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(valid))).reshape(b, h, hd)
    before = ops.decode_attention.launches
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(valid, torch.bool))
    assert ops.decode_attention.launches == before   # no kernel on the CPU
    got_ref = decode_attention_ref(_t(q).reshape(b, hkv, g, hd), _t(k),
                                   _t(v), _t(valid, torch.bool))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_ref.reshape(b, h, hd).numpy(), want_ref,
                               rtol=0, atol=1e-5)
    assert not got[0].any()                         # all-invalid row -> 0


def test_plain_version_matches_reference_bf16():
    q, k, v, valid = _inputs(1, b=3, s=200, hkv=2, g=3, hd=32)
    b, h, hd = q.shape
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_decode(*jb, jnp.asarray(valid), block_s=64),
                      np.float32)
    pb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.decode_attention(*pb, _t(valid, torch.bool))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    assert not got[0].any()


def test_attend_decode_matches_reference_einsum_fp32():
    """Rows with at least one valid position: the port's attend_decode
    (kernel contract) equals the reference's einsum form in fp32."""
    q, k, v, valid = _inputs(2, all_invalid_row=False)
    b, h, hd = q.shape
    want = j_attend_decode(jnp.asarray(q)[:, None], jnp.asarray(k),
                           jnp.asarray(v), jnp.asarray(valid))
    got = attend_decode(_t(q)[:, None], _t(k), _t(v), _t(valid, torch.bool))
    assert tuple(got.shape) == (b, 1, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_attend_decode_contract_differs_from_einsum_form():
    """The two stated differences from the reference's einsum form: (1) an
    all-invalid row gives 0, not NaN; (2) in bf16, p stays fp32 for p·V,
    so the port lands on the fp32 oracle rounded once to bf16, where the
    einsum form (p cast to bf16 first) does not."""
    q, k, v, valid = _inputs(3, s=512, hd=32)
    want = np.asarray(j_attend_decode(jnp.asarray(q)[:, None],
                                      jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(valid)))
    got = attend_decode(_t(q)[:, None], _t(k), _t(v),
                        _t(valid, torch.bool)).numpy()
    assert np.isnan(want[0]).all() and not got[0].any()

    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    b, h, hd = q.shape
    exact = decode_attention_ref(qb.float().reshape(b, 2, 3, hd), kb.float(),
                                 vb.float(), _t(valid, torch.bool))
    exact = exact.reshape(b, h, hd)[1:]
    port = attend_decode(qb[:, None], kb, vb, _t(valid, torch.bool))[1:, 0]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    einsum = np.asarray(j_attend_decode(jq[:, None], jk, jv,
                                        jnp.asarray(valid)), np.float32)
    once = exact.to(torch.bfloat16).float()
    assert float((port.float() - once).abs().max()) == 0.0
    assert np.abs(einsum[1:, 0] - once.numpy()).max() > 0.0


# ------------------------------------------------ the CUDA kernel's algorithm
def _split_k(q, k, v, valid, split_len):
    """fp32 numpy emulation of the CUDA kernel's split-K decode: per split
    of ``split_len`` positions an (m, l, acc) of the valid positions (an
    empty split gives m = -inf and is skipped), merged in split order with
    c = exp(m - M), out = Σ c·acc / max(Σ c·l, 1e-20); so a row with no
    valid position gives 0. q (B, Hkv, G, hd), k/v (B, S, Hkv, hd)."""
    f32 = np.float32
    q, k, v = (np.asarray(a, f32) for a in (q, k, v))
    s, hd = k.shape[1], q.shape[-1]
    scale = f32(1.0 / np.sqrt(hd))
    parts = []
    for s0 in range(0, s, split_len):
        ok = valid[:, s0:s0 + split_len]                          # (B, n)
        sc = np.einsum("bhgd,bnhd->bhgn", q, k[:, s0:s0 + split_len]) * scale
        sc = np.where(ok[:, None, None, :], sc, -np.inf).astype(f32)
        m = sc.max(-1)                                            # (B,Hkv,G)
        with np.errstate(invalid="ignore"):
            p = np.where(np.isfinite(sc), np.exp(sc - m[..., None]), 0)
        p = p.astype(f32)
        parts.append((m, p.sum(-1, dtype=f32),
                      np.einsum("bhgn,bnhd->bhgd", p, v[:, s0:s0 + split_len])))
    big_m = np.max([m for m, _, _ in parts], axis=0)
    acc = np.zeros(q.shape, f32)
    den = np.zeros(q.shape[:-1], f32)
    for m, l, a in parts:                                         # split order
        live = np.isfinite(m)
        with np.errstate(invalid="ignore"):                   # -inf - -inf
            c = np.where(live, np.exp(np.where(live, m - big_m, 0)), 0)
        c = c.astype(f32)
        acc = (acc + c[..., None] * a).astype(f32)
        den = (den + c * l).astype(f32)
    return acc / np.maximum(den, f32(1e-20))[..., None]


@pytest.mark.parametrize("split_len", [1, 7, 64, 128, None])
def test_split_k_emulation_matches_plain_and_reference(split_len):
    """The kernel's split-K algorithm (``_split_k``) at split lengths 1, 7,
    64, 128 and S, on masks with whole empty splits, a row valid only at its
    last position and an all-invalid row, against the port's plain version
    and the JAX reference (its Pallas kernel in interpret mode and its
    oracle). fp32, 1e-5 absolute: the same sums split and merged in
    another order."""
    q, k, v, valid = _inputs(4, b=5, s=300, hkv=2, g=3, hd=16)
    valid[1] = False
    valid[1, -1] = True                          # one valid, the last slot
    valid[2] = False
    valid[2, :5] = True
    valid[2, 250:260] = True                     # splits empty between
    valid[3, 130:] = False                       # a prefix: late splits empty
    b, h, hd = q.shape
    hkv, g = k.shape[2], h // k.shape[2]
    got = _split_k(q.reshape(b, hkv, g, hd), k, v, valid,
                   split_len or k.shape[1]).reshape(b, h, hd)
    assert not got[0].any()                      # all-invalid row -> 0
    plain = ops.decode_attention(_t(q), _t(k), _t(v), _t(valid, torch.bool))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-5)
    want_kernel = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(valid),
                                      block_s=64))
    want_ref = np.asarray(j_ref(jnp.asarray(q).reshape(b, hkv, g, hd),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(valid))).reshape(b, h, hd)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,hkv,s,sms,want", [
    (8, 8, 2048, 132, (2, 16)),      # phi4-mini's tick on an H100
    (1, 8, 2048, 132, (1, 32)),      # one slot: a tile per split
    (64, 8, 2048, 132, (8, 4)),      # many slots: the longest splits
    (8, 8, 1, 132, (1, 1)),
    (2, 2, 65, 132, (1, 2)),         # one past a tile
    (64, 8, 2048, 16, (8, 4)),
    (8, 8, 2048, 8, (8, 4)),         # few SMs: the longest splits
    (1, 1, 8 * 64 * 512, 132, (8, 512)),   # the longest S: MAX_SPLITS
])
def test_split_plan_from_the_shapes(b, hkv, s, sms, want):
    """The wrapper's launch plan is a function of the shapes and the SM
    count alone (no look at the mask): splits cover S exactly in tiles,
    at most MAX_TILES tiles each, as long as the blocks still number
    BLOCKS_PER_SM per SM."""
    tiles, splits = ops.plan(b, hkv, s, sms)
    assert (tiles, splits) == want
    assert 1 <= tiles <= ops.MAX_TILES and tiles & (tiles - 1) == 0
    span = tiles * ops.TILE
    assert (splits - 1) * span < s <= splits * span
    assert splits <= ops.MAX_SPLITS and s <= ops.MAX_S
    n_tiles = -(-s // ops.TILE)
    if tiles > 1 and -(-n_tiles // (tiles // 2)) <= ops.MAX_SPLITS:
        # doubled for occupancy, not for MAX_SPLITS
        assert b * hkv * splits >= ops.BLOCKS_PER_SM * sms
