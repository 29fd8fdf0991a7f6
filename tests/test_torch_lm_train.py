"""The port's LM training forward, loss and gradients against the JAX
package's (``repro.models.lm``), on the CPU.

Both sides run the same weights: the reference's ``init_lm`` output in
fp32, carried over with ``convert.lm_params_from_jax``; the smoke widths
of all five LM configs (GQA with and without QKV bias, tied and untied
embeddings, MLA, MoE with a shared expert and a dense first layer, a
sliding window). Inputs are numpy-seeded; the JAX side runs under
``jax.jit``.

- ``xent_loss`` against the reference's and against ``log_softmax`` /
  ``take_along_axis`` (the twin of ``tests/test_lm.py``'s
  ``test_vocab_sharded_xent_matches_dense``).
- ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's, remat on and off, with query blocks.
- Remat on and off give the same bits on the port; the bf16 barrier is a
  bitwise no-op in bf16; a MoE layer under remat appends one routing.
- The token lookup's transpose (the in-place segment sum over the distinct
  tokens) equals autograd's ``index_put_`` gradient bit for bit, tied and
  untied, and the reference's gradient for a batch of repeated tokens.

Tolerances: loss 1e-5, gradients 1e-4 · max(1, max |want|) per leaf (PR
20's 1e-4 in fp32: matmuls and sums in another order through two layers
and their backward). MoE routing can flip where a token's k-th and
(k+1)-th router probabilities are within 1e-6 (the fp32 router matmuls
differ in the last bit); such a case is not compared, with a warning.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.layers.attention import attend_full as j_attend_full
from repro.models import lm as jlm
from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import smoke_config
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.segment_reduce import ops
from repro_torch.layers import moe
from repro_torch.layers.attention import attend_full
from repro_torch.models import lm

LM_ARCHS = ("deepseek-67b", "qwen2-72b", "phi4-mini-3.8b", "mixtral-8x7b",
            "deepseek-v2-lite-16b")
NEAR_TIE = 1e-6
REL = 1e-4


def _pair(arch, **kw):
    jcfg = jsmoke(arch).replace(dtype="float32", **kw)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, LMConfig(**dataclasses.asdict(jcfg)), pp


def _batch(vocab, shape=(2, 16), seed=1, repeat=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab if repeat is None else repeat,
                        (shape[0], shape[1] + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _near_tie(cfg, pp, tokens) -> bool:
    routings = []
    with torch.no_grad():
        lm.forward(cfg, pp, torch.from_numpy(tokens), moe_routings=routings)
    if any(float(moe.near_tie_gap(r)) < NEAR_TIE for r in routings):
        warnings.warn(f"{cfg.arch_id}: router near-tie, not compared")
        return True
    return False


def _port_grads(cfg, pp, batch, opts):
    live = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    loss, parts = lm.loss_fn(cfg, live,
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             None, opts)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            [t.grad for t in leaves(live)])


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------------ xent
def test_xent_matches_reference_and_dense():
    """The twin of test_lm.py's vocab-sharded xent check, and the
    reference's own ``xent_loss`` on the same logits."""
    cfg = smoke_config("deepseek-67b")
    jcfg = jsmoke("deepseek-67b")
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, cfg.vocab_size)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ours = float(lm.xent_loss(cfg, torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    dense = float(-jnp.mean(jnp.take_along_axis(
        lp, jnp.asarray(labels)[..., None], -1)))
    ref = float(jlm.xent_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(ours - dense) < 1e-4
    assert abs(ours - ref) < 1e-5


def test_xent_gradient_matches_reference():
    """bf16 logits in, fp32 math: the gradient of the gather form equals
    the one-hot form's (jax.grad of the reference's)."""
    cfg, jcfg = smoke_config("phi4-mini-3.8b"), jsmoke("phi4-mini-3.8b")
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 6, cfg.vocab_size)).astype(np.float32) * 4
    labels = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    t = torch.from_numpy(logits).requires_grad_(True)
    lm.xent_loss(cfg, t, torch.from_numpy(labels)).backward()
    jg = jax.grad(lambda x: jlm.xent_loss(jcfg, x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    _close(t.grad, jg, 1e-6)


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """``loss_fn`` and every leaf's gradient against
    ``jax.value_and_grad``, with 8-row query blocks over 16 tokens."""
    jcfg, jp, cfg, pp = _pair(arch)
    batch = _batch(cfg.vocab_size)
    if _near_tie(cfg, pp, batch["tokens"]):
        return
    jopts = jlm.ExecOpts(q_block=8, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb, None, jopts), has_aux=True))(jp)
    loss, parts, grads = _port_grads(cfg, pp, batch,
                                     lm.ExecOpts(q_block=8, remat=remat))
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert abs(float(parts["xent"]) - float(jparts["xent"])) <= 1e-5
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= 1e-5
    want = leaves(lm_params_from_jax(jax.tree.map(np.asarray, jg),
                                     device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w.numpy())


def test_repeated_tokens_gradient_matches_reference():
    """A batch of 32 tokens drawn from 5 ids: the embedding's gradient
    sums many rows per token (tied: into the logits' gradient)."""
    for arch in ("phi4-mini-3.8b", "qwen2-72b"):
        jcfg, jp, cfg, pp = _pair(arch)
        batch = _batch(cfg.vocab_size, (2, 16), seed=4, repeat=5)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        opts = jlm.ExecOpts(q_block=0, remat=False)
        jg = jax.jit(jax.grad(
            lambda p: jlm.loss_fn(jcfg, p, jb, None, opts)[0]))(jp)
        _, _, grads = _port_grads(cfg, pp, batch,
                                  lm.ExecOpts(q_block=0, remat=False))
        want = lm_params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
        _close(grads[0], want["embed"].numpy())
        assert cfg.tie_embeddings == ("head" not in pp)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_on_and_off_are_bitwise_equal(arch):
    """Recomputing a layer in the backward repeats its forward's ops on
    the same inputs: the same bits, loss and every gradient."""
    _, _, cfg, pp = _pair(arch)
    batch = _batch(cfg.vocab_size)
    a = _port_grads(cfg, pp, batch, lm.ExecOpts(q_block=8, remat=False))
    b = _port_grads(cfg, pp, batch, lm.ExecOpts(q_block=8, remat=True))
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-lite-16b"])
def test_bf16_barrier_is_a_bitwise_noop(arch):
    """In bf16 the barrier casts a bf16 cotangent to bf16: with and
    without it, a step's gradients have the same bits."""
    cfg = smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    pp = lm.init_lm(cfg, 0, device="cpu")
    batch = _batch(cfg.vocab_size)
    on = _port_grads(cfg, pp, batch, lm.ExecOpts(q_block=8))
    off = _port_grads(cfg, pp, batch,
                      lm.ExecOpts(q_block=8, bf16_grad_barrier=False))
    assert torch.equal(on[0], off[0])
    assert all(g.dtype == p.dtype for g, p in zip(on[2], leaves(pp)))
    assert all(torch.equal(x, y) for x, y in zip(on[2], off[2]))
    x = torch.randn(3, 4, dtype=torch.bfloat16, requires_grad=True)
    assert lm.barrier_apply(x, lm.ExecOpts()) is not x
    assert lm.barrier_apply(x.float(), lm.ExecOpts()).dtype == torch.float32


def test_exec_opts_match_reference():
    assert ([f.name for f in dataclasses.fields(lm.ExecOpts)]
            == [f.name for f in dataclasses.fields(jlm.ExecOpts)])
    assert dataclasses.asdict(lm.ExecOpts()) == \
        dataclasses.asdict(jlm.ExecOpts())


def test_remat_appends_one_routing_per_moe_layer():
    _, _, cfg, pp = _pair("deepseek-v2-lite-16b")
    live = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    routings = []
    toks = torch.from_numpy(_batch(cfg.vocab_size)["tokens"])
    logits, aux = lm.forward(cfg, live, toks, None, lm.ExecOpts(q_block=8),
                             moe_routings=routings)
    (logits.float().square().mean() + aux).backward()
    assert len(routings) == cfg.n_layers - cfg.first_dense_layers


def test_query_blocks_match_reference_attend_full():
    """``attend_full`` in 4 query blocks equals one block and the
    reference's blocked form (GQA groups, a window, MLA's wider q/k)."""
    rng = np.random.default_rng(5)
    for hd, dv, window in ((16, 16, 0), (16, 16, 6), (24, 16, 0)):
        q = rng.normal(size=(2, 16, 4, hd)).astype(np.float32)
        k = rng.normal(size=(2, 16, 2, hd)).astype(np.float32)
        v = rng.normal(size=(2, 16, 2, dv)).astype(np.float32)
        pos = np.arange(16)
        args = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
        blocked = attend_full(*args, window=window, q_block=4)
        one = attend_full(*args, window=window)
        if dv == hd:      # the reference repeats K/V per head: dv == hd
            ref = j_attend_full(*(jnp.asarray(a) for a in (q, k, v, pos,
                                                           pos)),
                                window=window, q_block=4)
            _close(blocked, ref, 1e-5)
        _close(blocked, one.numpy(), 1e-6)
        # a block that does not divide the queries: one block, as the
        # reference
        assert torch.equal(attend_full(*args, window=window, q_block=5), one)


# ----------------------------------------------------- the token transpose
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_token_transpose_equals_index_put_gradient(tied):
    """The lookup's gradient through the sink (the in-place segment sum
    over the distinct tokens, added into the logits' gradient when tied)
    equals autograd's ``table[tokens]`` gradient (``index_put_``
    accumulate) bit for bit in fp32, and launches nothing on the CPU."""
    arch = "phi4-mini-3.8b" if tied else "qwen2-72b"
    _, _, cfg, pp = _pair(arch)
    assert cfg.tie_embeddings == tied
    batch = _batch(cfg.vocab_size, (2, 24), seed=6, repeat=9)
    before = ops.segment_sum_csr_accumulate.launches
    got = _port_grads(cfg, pp, batch, lm.ExecOpts(q_block=0, remat=False))
    assert ops.segment_sum_csr_accumulate.launches == before

    def plain(cfg_, params, tokens):
        return params["embed"][tokens.long()], params["embed"]

    orig = lm._lookup
    lm._lookup = plain
    try:
        want = _port_grads(cfg, pp, batch,
                           lm.ExecOpts(q_block=0, remat=False))
    finally:
        lm._lookup = orig
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2][0], want[2][0])
    touched = np.unique(batch["tokens"])
    rows = torch.nonzero(got[2][0].abs().sum(1)).flatten().numpy()
    if not tied:
        np.testing.assert_array_equal(rows, touched)


def test_mesh_is_refused():
    """A mesh that is not a ``Mesh`` is refused (the mesh paths run since
    the mesh bodies were ported: ``tests/test_torch_mesh_models.py``)."""
    _, _, cfg, pp = _pair("phi4-mini-3.8b")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: lm.loss_fn(cfg, pp, {"tokens": tokens,
                                              "labels": tokens}, object()),
                 lambda: lm.forward(cfg, pp, tokens, object()),
                 lambda: lm.make_train_step(cfg, mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()
