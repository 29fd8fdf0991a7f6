"""Twin of ``tests/test_checkpoint.py`` on the port (``repro_torch
.checkpoint``): every reference case, with torch tensors in place of JAX
arrays and the exotic dtypes as torch's ``bfloat16`` / ``float8_e4m3fn`` /
``float8_e5m2`` (no ``ml_dtypes``), plus nested trees and the reference's
key paths.

Checkpoint substrate hardening: exotic dtypes, retention, tmp-dir GC,
async-failure surfacing, structured validation errors (docs/DESIGN.md §7.1)."""
import json
import os
import shutil
import tempfile
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    checkpoint_steps, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import flatten_with_paths


class TestExoticDtypes:
    @pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                       "float8_e5m2"])
    def test_roundtrip_bitwise(self, dtype):
        dt = getattr(torch, dtype)
        g = torch.Generator().manual_seed(0)
        arr = torch.randn((9, 5), generator=g).to(dt)
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(tmp, 1, {"x": arr})
            got, _, _ = restore_checkpoint(tmp, {"x": arr})
            assert got["x"].dtype == dt
            # compare raw bits, not values (NaNs etc. must survive too)
            a = got["x"].view(torch.uint8)
            assert torch.equal(a, arr.view(torch.uint8))

    def test_flat_restore_preserves_host_dtypes(self):
        tree = {"i64": np.arange(4, dtype=np.int64),
                "f64": np.ones(3, np.float64),
                "bf16": torch.ones(3, dtype=torch.bfloat16)}
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(tmp, 2, tree)
            got, step, _ = restore_checkpoint(tmp, like=None)
            assert step == 2
            assert got["i64"].dtype == np.int64      # no silent 32-bit cast
            assert got["f64"].dtype == np.float64
            assert got["bf16"].dtype == torch.bfloat16


class TestRetentionAndTmp:
    def test_retention_keeps_exactly_k(self):
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp, keep=3, async_writes=False)
            for s in range(1, 8):
                mgr.save(s, {"w": torch.full((2,), float(s))})
            assert checkpoint_steps(tmp) == [5, 6, 7]

    def test_restore_latest_skips_and_gcs_tmp_survivor(self):
        tree = {"w": torch.zeros((2,))}
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp, keep=5, async_writes=False)
            mgr.save(1, {"w": torch.full((2,), 1.0)})
            mgr.save(3, {"w": torch.full((2,), 3.0)})
            # a crashed writer's leftover: newer step number, but only .tmp
            leftover = os.path.join(tmp, "step_00000009.tmp")
            os.makedirs(leftover)
            with open(os.path.join(leftover, "leaf_00000.npy"), "wb") as f:
                f.write(b"partial")
            got, step, _ = mgr.restore_latest(tree)
            assert step == 3                      # .tmp is never a candidate
            np.testing.assert_allclose(got["w"].numpy(), 3.0)
            assert not os.path.exists(leftover)   # and it was GC'd

    def test_concurrent_save_restore_ordering(self):
        # async saves from one thread racing restore_latest from another:
        # restore must always see a *complete* checkpoint (atomic rename),
        # and after the final wait() the latest step is the last save
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp, keep=10, async_writes=True)
            errors = []

            def reader():
                for _ in range(20):
                    try:
                        got, step, _ = mgr.restore_latest(like=None)
                        np.testing.assert_allclose(
                            np.asarray(got["w"]), float(step))
                    except FileNotFoundError:
                        pass                      # nothing written yet: fine
                    except Exception as e:        # noqa: BLE001
                        errors.append(e)

            t = threading.Thread(target=reader)
            t.start()
            for s in range(1, 9):
                mgr.save(s, {"w": torch.full((3,), float(s))})
            mgr.wait()
            t.join(timeout=60)
            assert not t.is_alive()
            assert not errors
            _, step, _ = mgr.restore_latest(like=None)
            assert step == 8

    def test_save_copies_before_background_write(self):
        """The manager copies to the host in the calling thread: an in-place
        write to the live tensor after ``save`` returns does not reach the
        file."""
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp, keep=2, async_writes=True)
            w = torch.zeros((1 << 16,))
            mgr.save(1, {"w": w})
            w.fill_(7.0)
            mgr.wait()
            got, _, _ = restore_checkpoint(tmp, like=None)
            assert not got["w"].any()


class TestAsyncErrorSurfacing:
    def test_background_failure_raises_on_next_call(self):
        tmp = tempfile.mkdtemp()
        try:
            mgr = CheckpointManager(tmp, keep=2, async_writes=True)
            mgr.save(1, {"w": torch.zeros((2,))})
            mgr.wait()
            # break the directory out from under the background writer
            shutil.rmtree(tmp)
            with open(tmp, "w") as f:
                f.write("not a directory")
            mgr.save(2, {"w": torch.zeros((2,))})
            with pytest.raises(CheckpointError, match="background"):
                mgr.wait()
            # surfaced exactly once: the next wait is clean
            mgr.wait()
        finally:
            if os.path.isfile(tmp):
                os.unlink(tmp)
            shutil.rmtree(tmp, ignore_errors=True)


class TestValidation:
    def _save_one(self, tmp):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": torch.ones((4,), dtype=torch.int32)}
        save_checkpoint(tmp, 1, tree)
        return tree

    def test_corrupt_leaf_names_leaf(self):
        with tempfile.TemporaryDirectory() as tmp:
            tree = self._save_one(tmp)
            leaf = os.path.join(tmp, "step_00000001", "leaf_00000.npy")
            raw = bytearray(open(leaf, "rb").read())
            raw[-2] ^= 0xFF
            with open(leaf, "wb") as f:
                f.write(raw)
            with pytest.raises(CheckpointError, match="crc32") as ei:
                restore_checkpoint(tmp, tree)
            assert ei.value.leaf == "a"

    def test_shape_mismatch_names_leaf(self):
        with tempfile.TemporaryDirectory() as tmp:
            tree = self._save_one(tmp)
            bad = dict(tree, b=torch.ones((5,), dtype=torch.int32))
            with pytest.raises(CheckpointError, match="shape") as ei:
                restore_checkpoint(tmp, bad)
            assert ei.value.leaf == "b"

    def test_dtype_mismatch_names_leaf(self):
        with tempfile.TemporaryDirectory() as tmp:
            tree = self._save_one(tmp)
            bad = dict(tree, b=torch.ones((4,), dtype=torch.float32))
            with pytest.raises(CheckpointError, match="dtype") as ei:
                restore_checkpoint(tmp, bad)
            assert ei.value.leaf == "b"

    def test_structure_change_is_structured_error(self):
        with tempfile.TemporaryDirectory() as tmp:
            tree = self._save_one(tmp)
            with pytest.raises(CheckpointError, match="structure"):
                restore_checkpoint(tmp, {"a": tree["a"]})

    def test_torn_manifest(self):
        with tempfile.TemporaryDirectory() as tmp:
            self._save_one(tmp)
            mpath = os.path.join(tmp, "step_00000001", "manifest.json")
            blob = open(mpath).read()
            with open(mpath, "w") as f:
                f.write(blob[: len(blob) // 2])   # torn write
            with pytest.raises(CheckpointError, match="manifest"):
                restore_checkpoint(tmp, like=None)

    def test_manifest_json_is_valid(self):
        with tempfile.TemporaryDirectory() as tmp:
            self._save_one(tmp)
            m = json.load(open(os.path.join(tmp, "step_00000001",
                                            "manifest.json")))
            assert {r["key"] for r in m["leaves"]} == {"a", "b"}
            assert all("crc32" in r for r in m["leaves"])


class _Pair(NamedTuple):
    lo: torch.Tensor
    hi: np.ndarray


class TestNestedTrees:
    def test_key_paths_and_round_trip(self):
        """Nested dicts, lists, tuples, NamedTuples and None: the reference's
        key paths (``jax.tree_util`` order: dict keys sorted), and a
        ``like=`` restore rebuilds the structure with torch leaves."""
        tree = {"z": [torch.arange(3), (torch.ones(2), None)],
                "a": {"p": _Pair(torch.zeros(2, 2), np.arange(4))}}
        keys = [k for k, _ in flatten_with_paths(tree)]
        assert keys == ["a/p/lo", "a/p/hi", "z/[0]", "z/[1]/[0]"]
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(tmp, 4, tree)
            got, step, _ = restore_checkpoint(tmp, tree)
            assert step == 4
            assert isinstance(got["a"]["p"], _Pair)
            assert got["z"][1][1] is None
            assert torch.equal(got["z"][0], tree["z"][0])
            assert torch.equal(got["a"]["p"].hi, torch.arange(4))
