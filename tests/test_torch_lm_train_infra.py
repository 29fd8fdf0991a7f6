"""The port's training infrastructure against the JAX package's, on the
CPU: the data pipeline (``repro_torch.data.pipeline``: the streams' arrays
equal the reference's bit for bit, the ``Prefetcher``'s order and its
close/restart contract), gradient compression
(``repro_torch.train.compression``: results equal the reference's, top-k
ids included) with the twins of ``tests/test_infra.py``'s
``TestCompression`` and ``TestPipeline``, and the training launcher
(``repro_torch.launch.train``: the LM and EGNN branches run on the CPU,
recsys is refused naming ROADMAP Step 10).
"""
import pytest

pytest.importorskip("torch")

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import torch

from repro.data import pipeline as j_pipe
from repro.train import compression as j_comp
from repro_torch.data.pipeline import (Prefetcher, SyntheticLMStream,
                                       SyntheticRecsysStream)
from repro_torch.launch import train as launch
from repro_torch.train import compression as t_comp

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ----------------------------------------------------------------- pipeline
class TestPipeline:
    """Twins of ``tests/test_infra.py::TestPipeline``, plus bit equality
    with the reference's streams."""

    def test_determinism(self):
        s = SyntheticLMStream(100, 2, 8, seed=3)
        a = s.batch_at(5)
        b = s.batch_at(5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = s.batch_at(6)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_recsys_stream(self):
        s = SyntheticRecsysStream(8, 100, 16)
        b = s.batch_at(0)
        assert b["ids"].shape == (16, 8) and set(np.unique(b["labels"])) <= {0, 1}

    @pytest.mark.parametrize("step", [0, 1, 17])
    def test_streams_equal_the_reference(self, step):
        for ours, ref in (
                (SyntheticLMStream(200_064, 2, 33, seed=4),
                 j_pipe.SyntheticLMStream(200_064, 2, 33, seed=4)),
                (SyntheticRecsysStream(39, 1000, 64, seed=2),
                 j_pipe.SyntheticRecsysStream(39, 1000, 64, seed=2))):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_order_and_restart():
    """Batches come in step order; after ``close()`` the queue is empty and
    ``start()`` resumes at the next unconsumed step, with that step's
    batch; a closed prefetcher stops iterating."""
    stream = SyntheticLMStream(50, 2, 4, seed=1)
    pf = Prefetcher(stream, start_step=3, depth=2)
    try:
        got = [next(pf) for _ in range(4)]
        assert [s for s, _ in got] == [3, 4, 5, 6]
        for s, b in got:
            np.testing.assert_array_equal(b["tokens"],
                                          stream.batch_at(s)["tokens"])
        pf.close()
        assert pf.q is None and pf.step == 7
        with pytest.raises(StopIteration):
            next(pf)
        pf.close()                                   # idempotent
        pf.start()
        s, b = next(pf)
        assert s == 7
        np.testing.assert_array_equal(b["labels"],
                                      stream.batch_at(7)["labels"])
    finally:
        pf.close()
    assert pf._thread is None


# -------------------------------------------------------------- compression
class TestCompression:
    """Twins of ``tests/test_infra.py::TestCompression``."""

    def test_error_feedback_conserves_signal(self):
        g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
            size=(64,)).astype(np.float32))}
        ef = t_comp.init_error_feedback(g)
        steps = 40
        total = torch.zeros((64,))
        for _ in range(steps):
            comp, ef = t_comp.compress_grads_topk(g, ef, frac=0.1)
            total = total + comp["w"]
        dense = steps * g["w"]
        rel = float(torch.linalg.norm(total - dense) / torch.linalg.norm(dense))
        assert rel < 0.15

    def test_int8_roundtrip_small_error(self):
        g = {"w": torch.from_numpy(np.random.default_rng(1).normal(
            size=(128,)).astype(np.float32))}
        ef = t_comp.init_error_feedback(g)
        comp, ef = t_comp.compress_grads_int8(g, ef)
        rel = float(torch.linalg.norm(comp["w"] - g["w"])
                    / torch.linalg.norm(g["w"]))
        assert rel < 0.02


def _tree(rng, ties=False):
    w = rng.normal(size=(8, 33)).astype(np.float32)
    if ties:     # many equal magnitudes: the top-k's order at ties shows
        w = np.round(w * 2) / 2
    return {"w": w, "b": {"c": rng.normal(size=(300,)).astype(np.float32)}}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_compression_equals_the_reference(ties):
    """Five steps of error-feedback top-k on a two-leaf tree: the
    compressed gradients and residuals equal the reference's bit for bit,
    and one leaf's (values, ids) too."""
    rng = np.random.default_rng(7)
    trees = [_tree(rng, ties) for _ in range(5)]
    jef = j_comp.init_error_feedback(trees[0])
    tef = t_comp.init_error_feedback(
        {"w": torch.zeros(8, 33), "b": {"c": torch.zeros(300)}})
    for tree in trees:
        jc, jef = j_comp.compress_grads_topk(
            {"w": jnp.asarray(tree["w"]), "b": {"c": jnp.asarray(tree["b"]["c"])}},
            jef, frac=0.07)
        tc, tef = t_comp.compress_grads_topk(
            {"w": torch.from_numpy(tree["w"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}, tef, frac=0.07)
        for a, b in ((tc["w"], jc["w"]), (tc["b"]["c"], jc["b"]["c"]),
                     (tef.residual["w"], jef.residual["w"]),
                     (tef.residual["b"]["c"], jef.residual["b"]["c"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    acc = tef.residual["w"] + torch.from_numpy(trees[0]["w"])
    tv, ti = t_comp.topk_compress(acc, 0.1)
    jv, ji = j_comp.topk_compress(jnp.asarray(acc.numpy()), 0.1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_int8_compression_equals_the_reference():
    rng = np.random.default_rng(8)
    trees = [_tree(rng) for _ in range(3)]
    jef = j_comp.init_error_feedback(trees[0])
    tef = t_comp.init_error_feedback(
        {"w": torch.zeros(8, 33), "b": {"c": torch.zeros(300)}})
    for tree in trees:
        jc, jef = j_comp.compress_grads_int8(
            {"w": jnp.asarray(tree["w"]), "b": {"c": jnp.asarray(tree["b"]["c"])}},
            jef)
        tc, tef = t_comp.compress_grads_int8(
            {"w": torch.from_numpy(tree["w"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}, tef)
        np.testing.assert_array_equal(tc["w"].numpy(), np.asarray(jc["w"]))
        np.testing.assert_array_equal(tef.residual["b"]["c"].numpy(),
                                      np.asarray(jef.residual["b"]["c"]))
    x = rng.normal(size=(1000,)).astype(np.float32) * 3
    tq, ts = t_comp.int8_compress(torch.from_numpy(x).to(torch.bfloat16))
    jq, js = j_comp.int8_compress(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


# ----------------------------------------------------------------- launcher
def test_launcher_trains_xdeepfm_and_refuses_an_unknown_arch(tmp_path,
                                                             capsys):
    """The launcher trains xdeepfm on the recsys stream, and an unknown
    arch raises KeyError."""
    args = ["--arch", "xdeepfm", "--steps", "2", "--batch", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    loss = launch.main(args)
    # the BCE of near-zero logits at random init: about ln 2
    assert abs(loss - np.log(2)) < 0.1
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(KeyError, match="no-such-arch"):
        launch.main(["--arch", "no-such-arch", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "egnn", "dimenet",
                                  "nequip", "equiformer-v2", "xdeepfm"])
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    """Four steps of the smoke config with a checkpoint every 2; a second
    launch on the same directory restores the last step."""
    args = ["--arch", arch, "--steps", "4", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    loss = launch.main(args)
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "final loss" in out
    steps = [json.loads(l)["step"] for l in out.splitlines()
             if l.startswith("{")]
    assert steps == [1, 2, 3, 4]
    assert launch.main(args) is None
    assert "restored from step 4" in capsys.readouterr().out


def test_launcher_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "qwen2-72b", "--steps", "2", "--batch", "2",
                        "--seq", "8", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "final loss" in r.stdout
