"""The port's quantization (``repro_torch.core.quantization``) against the
JAX package's.

int8 and 4-bit codes, vmin and scale are byte-identical: both packages do
the same fp32 steps. 16-bit, ``dequantize`` and ``quantized_scores`` agree
to fp32 tolerance (1e-6 relative on dequantized values, 1e-5 absolute on
scores of unit-norm rows, whose matmuls sum in another order).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import jax.numpy as jnp
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as pq


def _rows(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [24, 33, 64])
def test_codes_byte_identical(rng, bits, d):
    x = _rows(rng, 300, d)
    x[0] = 0.5                               # constant row: scale clamps
    a = jq.quantize(jnp.asarray(x), bits)
    b = pq.quantize(torch.from_numpy(x), bits)
    assert b.data.dtype == torch.int8 and (b.bits, b.dim) == (a.bits, a.dim)
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(b.vmin.numpy(), np.asarray(a.vmin))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert b.nbytes == a.nbytes


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_dequantize_and_scores_match(rng, bits):
    d = 33
    x = _rows(rng, 200, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = _rows(rng, 9, d)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = jq.quantize(jnp.asarray(x), bits)
    b = pq.quantize(torch.from_numpy(x), bits)
    np.testing.assert_allclose(b.data.float().numpy(),
                               np.asarray(a.data.astype(jnp.float32)), rtol=0)
    np.testing.assert_allclose(pq.dequantize(b).numpy(),
                               np.asarray(jq.dequantize(a)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        pq.quantized_scores(torch.from_numpy(q), b).numpy(),
        np.asarray(jq.quantized_scores(jnp.asarray(q), a)), rtol=0, atol=1e-5)


def test_adaptive_policy_matches():
    for budget in (0, 1000):
        a, b = jq.AdaptiveQuantPolicy(budget), pq.AdaptiveQuantPolicy(budget)
        for cur in (0, 400, 600, 900, 1200):
            for default in (16, 8):
                assert b.choose_bits(cur, default) == a.choose_bits(cur, default)
