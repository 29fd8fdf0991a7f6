"""The port's LM train step (``models.lm.make_train_step``) against the JAX
package's, on the CPU: one step of every LM config at smoke widths in
fp32, with ``grad_accum`` 1 and 2 (micro-batches summed into an fp32
gradient), its new params, moments, step and metrics; and a step from a
reference state at step 3, carried over by ``convert.adamw_state_from_jax``
(the stacked moments split per layer). The JAX side runs under
``jax.jit``; the port's step updates its inputs in place.

Tolerances: loss and grad norm 1e-5 relative, lr 1e-6 relative (one
ulp of the cosine); moments 1e-4 · max(1, max
|want|) per leaf (PR 20's 1e-4 in fp32: the gradients' matmuls and sums
run in another order); new params 1e-5 absolute (they are O(0.3)). The
steps run with ε = 1e-3: at the default 1e-8, Adam's first updates
m̂/(√v̂ + ε) are close to sign(g) for gradients near ε, and such a
gradient, a sum of O(1) terms that nearly cancel, differs between the two
packages in its leading digits, which moves its update by up to ~lr. With
ε = 1e-3 the update is a smooth function of the gradient. The default ε
is held elsewhere: the in-place update equals ``adamw_update`` bit for bit
(``test_torch_lm_train_update.py``), which ``test_torch_train.py`` holds
against the reference's.
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
from repro.models import lm as jlm
from repro.train import optimizer as j_opt
from repro_torch.common.tree import leaves
from repro_torch.configs.base import LMConfig
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.train import optimizer as t_opt

LM_ARCHS = ("deepseek-67b", "qwen2-72b", "phi4-mini-3.8b", "mixtral-8x7b",
            "deepseek-v2-lite-16b")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, eps=1e-3)
NEAR_TIE = 1e-6


def _pair(arch):
    jcfg = jsmoke(arch).replace(dtype="float32")
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, LMConfig(**dataclasses.asdict(jcfg)), pp


def _batch(vocab, accum, micro=2, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (accum * micro, seq + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32)}
    if accum > 1:
        b = {k: v.reshape(accum, micro, seq) for k, v in b.items()}
    return b


def _near_tie(cfg, pp, tokens) -> bool:
    routings = []
    with torch.no_grad():
        for t in tokens.reshape(-1, *tokens.shape[-2:]):
            lm.forward(cfg, pp, torch.from_numpy(t), moe_routings=routings)
    if any(float(moe.near_tie_gap(r)) < NEAR_TIE for r in routings):
        warnings.warn(f"{cfg.arch_id}: router near-tie, not compared")
        return True
    return False


def _rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _check(jout, tout):
    jp, jo, jm = jout
    tp, to, tm = tout
    want_p = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want_o = adamw_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    assert int(to.step) == int(want_o.step)
    for g, w in zip(leaves(tp), leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    for tree, wtree in ((to.mu, want_o.mu), (to.nu, want_o.nu)):
        for g, w in zip(leaves(tree), leaves(wtree)):
            _rel(g, w.numpy(), 1e-4)
    assert set(tm) == set(jm)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    # the cosine schedule's cos: XLA's and torch's differ in the last bit
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(arch, accum):
    jcfg, jp, cfg, pp = _pair(arch)
    batch = _batch(cfg.vocab_size, accum)
    if _near_tie(cfg, pp, batch["tokens"]):
        return
    jstep = jax.jit(jlm.make_train_step(
        jcfg, None, jlm.ExecOpts(q_block=8), j_opt.AdamWConfig(**OPT),
        grad_accum=accum))
    jout = jstep(jp, j_opt.init_adamw(jp),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=8),
                               t_opt.AdamWConfig(**OPT), grad_accum=accum)
    state = t_opt.init_adamw(pp)
    tout = tstep(pp, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tout[0] is pp and tout[1] is state          # updated in place
    assert ("xent" in tout[2]) == (accum == 1)
    _check(jout, tout)


def test_step_from_a_reference_state_at_step_3():
    """Three reference steps, then the state carried over (params and the
    stacked moments split per layer): the fourth step on both sides."""
    jcfg, jp, cfg, _ = _pair("deepseek-v2-lite-16b")
    jstep = jax.jit(jlm.make_train_step(
        jcfg, None, jlm.ExecOpts(q_block=8), j_opt.AdamWConfig(**OPT)))
    jo = j_opt.init_adamw(jp)
    for s in range(3):
        b = {k: jnp.asarray(v)
             for k, v in _batch(cfg.vocab_size, 1, seed=10 + s).items()}
        jp, jo, _ = jstep(jp, jo, b)
    pp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    state = adamw_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    assert int(state.step) == 3 and len(state.mu["layers"]) == cfg.n_layers
    batch = _batch(cfg.vocab_size, 1, seed=20)
    if _near_tie(cfg, pp, batch["tokens"]):
        return
    jout = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=8),
                               t_opt.AdamWConfig(**OPT))
    tout = tstep(pp, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _check(jout, tout)
