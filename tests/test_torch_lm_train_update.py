"""The LM train step's own contracts on the port, on the CPU: the in-place
AdamW update (``train.optimizer.adamw_update_``) equals ``adamw_update``
bit for bit whatever its row blocks; a bf16 step with ``grad_accum`` 2
equals the functional computation (each micro-batch's bf16 gradient cast
and summed in fp32, then ``adamw_update``) bit for bit; a step that fails
before its update leaves the params and the state as they were; the twin
of ``tests/test_lm.py``'s ``test_training_reduces_loss``; the ``Trainer``'s
restart with the LM step is bitwise.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.models import lm
from repro_torch.train import optimizer as t_opt
from repro_torch.train.trainer import Trainer, TrainerConfig


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _batch(vocab, shape, seed=1):
    s = SyntheticLMStream(vocab, int(np.prod(shape[:-1])), shape[-1], seed)
    return {k: torch.from_numpy(v.reshape(shape))
            for k, v in s.batch_at(0).items()}


def _state_at_step_3(params, seed=0):
    """A state with non-zero moments at step 3."""
    g = torch.Generator().manual_seed(seed)

    def rnd(p, s):
        return torch.randn(p.shape, generator=g, dtype=torch.float32) * s

    return t_opt.AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        mu=tree_map(lambda p: rnd(p, 1e-2), params),
        nu=tree_map(lambda p: rnd(p, 1e-3).square(), params))


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_in_place_update_equals_adamw_update(n_blocks, clip, monkeypatch):
    """phi4-mini's smoke params in bf16 (the embedding 512 rows) with bf16
    gradients, and fp32 gradients (the accumulated sum): the embedding
    split into 1, 3 and 7 row blocks."""
    cfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(cfg, 0, device="cpu")
    rows, width = params["embed"].shape
    per = -(-rows // n_blocks)
    assert -(-rows // per) == n_blocks
    monkeypatch.setattr(t_opt, "UPDATE_BLOCK_ELEMS", per * width)
    ocfg = t_opt.AdamWConfig(lr=1e-2, warmup_steps=2, clip_norm=clip)
    g = torch.Generator().manual_seed(1)
    for gdtype in (torch.bfloat16, torch.float32):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=g).to(gdtype),
                         params)
        state = _state_at_step_3(params)
        want_p, want_s, want_m = t_opt.adamw_update(ocfg, grads, state, params)
        p, s = _clone(params), _clone(state)
        out = t_opt.adamw_update_(ocfg, grads, s, p)
        assert out[0] is p and out[1] is s
        assert _same(p, want_p) and _same(s, want_s)
        assert all(torch.equal(out[2][k], want_m[k]) for k in want_m)
        assert _same(state, _state_at_step_3(params))   # inputs untouched


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_grad_accum_step_equals_the_functional_computation(accum):
    """bf16 (remat, query blocks, the barrier): the step's new params,
    moments and loss equal the functional computation bit for bit: with
    grad_accum 2, each micro-batch's bf16 gradient (plain autograd) cast
    and summed in fp32, divided by 2, then ``adamw_update``; with 1, the
    bf16 gradient handed to ``adamw_update`` as it is (the step's fp32 sum
    holds it exactly)."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    params = lm.init_lm(cfg, 2, device="cpu")
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    batch = _batch(cfg.vocab_size, shape)
    opts = lm.ExecOpts(q_block=8)
    ocfg = t_opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    gsum, lsum = None, torch.zeros(())
    for a in range(accum):
        live = tree_map(lambda t: t.clone().requires_grad_(True), params)
        mb = {k: v[a] for k, v in batch.items()} if accum > 1 else batch
        loss, _ = lm.loss_fn(cfg, live, mb, None, opts)
        loss.backward()
        g = [t.grad if accum == 1 else t.grad.to(torch.float32)
             for t in leaves(live)]
        gsum = g if gsum is None else [x + y for x, y in zip(gsum, g)]
        lsum = lsum + loss.detach()
    it = iter([x / accum if accum > 1 else x for x in gsum])
    state = t_opt.init_adamw(params)
    want_p, want_s, want_m = t_opt.adamw_update(
        ocfg, tree_map(lambda _: next(it), params), state, params)
    step = lm.make_train_step(cfg, None, opts, ocfg, grad_accum=accum)
    p, s, m = step(_clone(params), t_opt.init_adamw(params), batch)
    assert _same(p, want_p) and _same(s, want_s)
    assert torch.equal(m["loss"], lsum / accum if accum > 1 else lsum)
    assert torch.equal(m["grad_norm"], want_m["grad_norm"])


def test_a_step_that_fails_before_its_update_leaves_the_state():
    """A label out of the vocabulary fails the loss's gather (in the
    second micro-batch): nothing was written."""
    cfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(cfg, 0, device="cpu")
    state = t_opt.init_adamw(params)
    keep_p, keep_s = _clone(params), _clone(state)
    batch = _batch(cfg.vocab_size, (2, 2, 8))
    batch["labels"][1, 0, 3] = cfg.vocab_size + 5
    step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=0),
                              grad_accum=2)
    with pytest.raises((RuntimeError, IndexError)):
        step(params, state, batch)
    assert _same(params, keep_p) and _same(state, keep_s)


def test_training_reduces_loss():
    """The twin of ``tests/test_lm.py::test_training_reduces_loss``:
    qwen2's smoke config (bf16, QKV bias, untied), 15 steps on one batch."""
    cfg = smoke_config("qwen2-72b")
    params = lm.init_lm(cfg, 0, device="cpu")
    opt = t_opt.init_adamw(params)
    step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=0, remat=False),
                              t_opt.AdamWConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=40))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    first = None
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first


def _trainer(tmp, total=5):
    cfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(cfg, 3, device="cpu")
    stream = SyntheticLMStream(cfg.vocab_size, 2 * 2, 16, seed=5)
    step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=8),
                              t_opt.AdamWConfig(lr=1e-2, warmup_steps=1),
                              grad_accum=2)

    def to_device(b):
        return {k: torch.from_numpy(v.reshape(2, 2, 16)) for k, v in b.items()}

    tcfg = TrainerConfig(total_steps=total, checkpoint_every=2,
                         checkpoint_dir=str(tmp), log_every=1)
    return Trainer(tcfg, step, stream, params, t_opt.init_adamw(params),
                   to_device)


def test_trainer_restart_is_bitwise_with_the_lm_step(tmp_path):
    """A failure at step 3 restores the step-2 checkpoint (new tensors;
    the in-place step had advanced the old ones) and re-runs steps 2-4 on
    their own batches: the state equals an uninterrupted run's."""
    plain = _trainer(tmp_path / "plain")
    out = plain.run()
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    failed = {"n": 0}

    def inject(step):
        if step == 3 and not failed["n"]:
            failed["n"] += 1
            raise RuntimeError("injected step failure")

    faulty = _trainer(tmp_path / "faulty")
    faulty.run(fail_injector=inject)
    assert failed["n"] == 1 and faulty.step == plain.step == 5
    assert _same(faulty.params, plain.params)
    assert _same(faulty.opt_state, plain.opt_state)
    assert int(faulty.opt_state.step) == 5
