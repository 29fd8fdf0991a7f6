"""Twin of ``tests/test_persistence.py`` on the port (``repro_torch
.persistence``, indexes on the CPU): every reference case, with the
reference's op script and golden prefix taken from the port's harness
(``repro_torch.persistence.crash_harness``), plus one subprocess ``kill -9``
run of that harness.

Durable index lifecycle: WAL framing + torn tails, snapshot round-trips,
crash recovery bit-identity, graceful degradation, fault-point sweep
(in-process ``mode="raise"``; the subprocess ``kill -9`` sweep is the
harness's ``--sweep``)."""
import pytest

pytest.importorskip("torch")

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointError
from repro_torch.core.index import HMGIIndex
from repro_torch.persistence import DurableHMGIIndex, OpLog, recover
from repro_torch.persistence import crash_harness as ch
from repro_torch.persistence import faultpoints
from repro_torch.persistence.faultpoints import POINTS, FaultInjected
from repro_torch.persistence.snapshot import snapshot_dir, snapshot_steps

DEV = "cpu"


@pytest.fixture(autouse=True)
def _disarmed():
    faultpoints.disarm()
    yield
    faultpoints.disarm()


@pytest.fixture()
def tmpdir_():
    d = tempfile.mkdtemp(prefix="hmgi_persist_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


class TestOpLog:
    def test_append_scan_roundtrip(self, tmpdir_):
        log = OpLog(tmpdir_)
        a = {"ids": np.arange(5, dtype=np.int32),
             "v": np.random.default_rng(0).standard_normal((5, 3))
                    .astype(np.float32)}
        s1 = log.append("insert", {"modality": "text"}, a)
        s2 = log.append("delete", {"modality": "text"},
                        {"ids": np.arange(2, dtype=np.int64)})
        log.close()
        assert (s1, s2) == (1, 2)
        log2 = OpLog(tmpdir_)
        recs = list(log2.scan())
        assert [r.seq for r in recs] == [1, 2]
        assert recs[0].op == "insert" and recs[0].meta == {"modality": "text"}
        np.testing.assert_array_equal(recs[0].arrays["v"], a["v"])
        assert recs[1].arrays["ids"].dtype == np.int64
        assert not log2.torn_tail

    def test_torn_tail_truncated_on_open(self, tmpdir_):
        log = OpLog(tmpdir_)
        for i in range(3):
            log.append("insert", {"i": i}, {"x": np.arange(i + 1)})
        log.close()
        path = log.segments()[0][1]
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 7)            # tear the last record mid-payload
        log2 = OpLog(tmpdir_)
        recs = list(log2.scan())
        assert [r.meta["i"] for r in recs] == [0, 1] and log2.torn_tail
        log2.open_for_append()
        assert log2.append("insert", {"i": 9}, {}) == 3   # seq continues
        log2.close()
        log3 = OpLog(tmpdir_)
        assert [r.meta["i"] for r in log3.scan()] == [0, 1, 9]
        assert not log3.torn_tail          # the tear was truncated away

    def test_corrupt_mid_record_stops_scan(self, tmpdir_):
        log = OpLog(tmpdir_)
        for i in range(3):
            log.append("insert", {"i": i}, {"x": np.arange(4)})
        log.close()
        path = log.segments()[0][1]
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 3] ^= 0xFF          # corrupt the middle record
        with open(path, "wb") as f:
            f.write(raw)
        log2 = OpLog(tmpdir_)
        recs = list(log2.scan())
        assert len(recs) < 3 and log2.torn_tail

    def test_rotate_and_gc(self, tmpdir_):
        log = OpLog(tmpdir_)
        for i in range(4):
            log.append("op", {"i": i}, {})
        log.rotate()                        # wal_5
        for i in range(4, 6):
            log.append("op", {"i": i}, {})
        assert len(log.segments()) == 2
        assert log.gc(4) == 1               # first segment fully ≤ floor
        assert [r.meta["i"] for r in log.scan()] == [4, 5]
        log.close()

    def test_empty_rotated_segment_pins_seq(self, tmpdir_):
        log = OpLog(tmpdir_)
        for _ in range(3):
            log.append("op", {}, {})
        log.rotate()
        log.gc(3)
        log.close()                         # only the empty wal_4 remains
        log2 = OpLog(tmpdir_)
        log2.open_for_append()
        assert log2.append("op", {}, {}) == 4
        log2.close()


class TestFaultPoints:
    def test_unknown_point_rejected(self):
        with pytest.raises(ValueError):
            faultpoints.arm("not.a.point")
        with pytest.raises(ValueError):
            faultpoints.crash_point("not.a.point")

    def test_raise_mode_counts_hits(self, tmpdir_):
        faultpoints.arm("wal.pre_append", hits=2, mode="raise")
        log = OpLog(tmpdir_)
        log.append("op", {}, {})            # hit 1: survives
        with pytest.raises(FaultInjected):
            log.append("op", {}, {})        # hit 2: fires
        log.close()


def _small_cfg():
    return ch.make_cfg()


def _golden(cfg, d):
    return ch.golden_index(cfg, d, device=DEV)


def _assert_same(a, b):
    ch.assert_bit_identical(a, b, "in-process")


class TestDurableLifecycle:
    def test_fresh_dir_guard(self, tmpdir_):
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        ch.apply_ops(idx, ch.scripted_ops(), until=1)
        idx.close()
        with pytest.raises(ValueError, match="recover"):
            DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)

    def test_wal_only_recovery(self, tmpdir_):
        # no snapshot ever written: recovery replays the whole log
        cfg = _small_cfg()
        ops = [e for e in ch.scripted_ops() if e[0] != "snapshot"]
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ops)
        idx.close()
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)
        assert rec.last_seq == d
        assert "no usable snapshot" in rec.metrics()["recovery"]
        _assert_same(rec, _golden(cfg, d))
        rec.close()

    def test_snapshot_plus_tail_recovery(self, tmpdir_):
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ch.scripted_ops())
        idx.close()
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)
        assert rec.last_seq == d
        assert "snapshot step" in rec.metrics()["recovery"]
        _assert_same(rec, _golden(cfg, d))
        # recovered index keeps working: mutate + snapshot + recover again
        rec.insert("text", np.arange(300, 310, dtype=np.int32),
                   np.random.default_rng(3).standard_normal((10, 12))
                     .astype(np.float32))
        assert rec.last_seq == d + 1
        rec.snapshot()
        rec.close()
        rec2 = recover(cfg, tmpdir_, seed=0, device=DEV)
        assert rec2.last_seq == d + 1
        _assert_same(rec2, rec)
        rec2.close()

    def test_recover_with_mesh_answers_as_live(self, tmpdir_):
        """``recover(mesh=)``: the recovered index searches through the
        row-sharded path (the replica is derived state, rebuilt on the
        first search) and answers as the live single-layout index, scores
        bit-equal; its durable state is the live one's."""
        from repro_torch.sharding import Mesh
        cfg = _small_cfg().replace(shard_layout="sharded")
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ch.scripted_ops())
        mesh = Mesh([DEV] * 4, ("data",))
        rec = recover(cfg, tmpdir_, mesh=mesh, seed=0, device=DEV)
        assert rec.last_seq == d and rec.mesh is mesh
        assert rec.device_layout("text").n_shards == 4
        _assert_same(rec, idx)
        q = ch.queries()
        for kw in (dict(), dict(where=("cat", "==", 1)), dict(n_probe=1)):
            got, want = rec.search(q, "text", k=5, **kw), idx.search(
                q, "text", k=5, **kw)
            assert torch.equal(got[0], want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        assert len(rec.modalities["text"].ivf_sharded) == 4
        idx.close()
        rec.close()

    def test_corrupt_newest_snapshot_degrades_with_warning(self, tmpdir_):
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ch.scripted_ops())   # writes 2 snapshots
        idx.close()
        steps = snapshot_steps(tmpdir_)
        assert len(steps) == 2
        leaf = os.path.join(snapshot_dir(tmpdir_), f"step_{steps[-1]:08d}",
                            "leaf_00000.npy")
        raw = bytearray(open(leaf, "rb").read())
        raw[-3] ^= 0xFF
        with open(leaf, "wb") as f:
            f.write(raw)
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)
        trail = rec.metrics()["recovery"]
        assert "WARNING" in trail and f"step {steps[-1]}" in trail
        assert f"snapshot step {steps[0]}" in trail   # fell back to previous
        assert rec.last_seq == d                      # longer replay, same end
        _assert_same(rec, _golden(cfg, d))
        rec.close()

    def test_config_fingerprint_mismatch_raises(self, tmpdir_):
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        ch.apply_ops(idx, ch.scripted_ops())
        idx.close()
        import dataclasses
        other = dataclasses.replace(cfg, quant_bits=4)
        with pytest.raises(CheckpointError, match="fingerprint"):
            recover(other, tmpdir_, seed=0, device=DEV)

    def test_torn_log_tail_recovers_prefix(self, tmpdir_):
        cfg = _small_cfg()
        ops = [e for e in ch.scripted_ops() if e[0] != "snapshot"]
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ops)
        idx.close()
        seg = sorted(os.listdir(os.path.join(tmpdir_, "wal")))[-1]
        path = os.path.join(tmpdir_, "wal", seg)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 11)
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)
        assert rec.last_seq == d - 1
        assert "truncated" in rec.metrics()["recovery"]
        _assert_same(rec, _golden(cfg, d - 1))
        rec.close()


class TestFaultSweepInProcess:
    """Every registered crash point, in-process (mode="raise"): the armed
    run dies at the boundary, recovery must be bit-identical to the golden
    prefix. The subprocess kill -9 version of this sweep is the harness's
    ``--sweep``."""

    @pytest.mark.parametrize("point", [p for p in POINTS
                                       if not p.startswith("recover.")])
    def test_crash_then_recover(self, point, tmpdir_):
        cfg = _small_cfg()
        faultpoints.arm(point, hits=ch.DEFAULT_HITS[point], mode="raise")
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        with pytest.raises(FaultInjected):
            ch.apply_ops(idx, ch.scripted_ops())
        faultpoints.disarm()
        idx.close()
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)
        d = rec.last_seq
        _assert_same(rec, _golden(cfg, d))
        rec.close()

    def test_crash_mid_replay_then_recover(self, tmpdir_):
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        d = ch.apply_ops(idx, ch.scripted_ops())
        idx.close()
        faultpoints.arm("recover.mid_replay", hits=2, mode="raise")
        with pytest.raises(FaultInjected):
            recover(cfg, tmpdir_, seed=0, device=DEV)
        faultpoints.disarm()
        rec = recover(cfg, tmpdir_, seed=0, device=DEV)  # replay re-runnable
        assert rec.last_seq == d
        _assert_same(rec, _golden(cfg, d))
        rec.close()


class TestKillNine:
    def test_harness_subprocess_post_append(self, tmpdir_):
        """The port's harness as a user runs it: a child process dies with
        exit code 137 at ``wal.post_append``, the parent recovers and holds
        search and hybrid_search bytes to the golden prefix."""
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        env.pop("HMGI_FAULTPOINT", None)
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.persistence.crash_harness",
             "--point", "wal.post_append", "--device", DEV,
             "--data-dir", tmpdir_],
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "wal.post_append: killed at hit 5, recovered 5 ops — OK" \
            in r.stdout


class TestDevice:
    def test_durable_entry_points_default_to_the_card(self, tmpdir_):
        """No device given means CUDA, as for ``HMGIIndex``: without a card
        both entry points raise, and create nothing."""
        import torch
        cfg = _small_cfg()
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the card tests cover it")
        with pytest.raises(RuntimeError, match="CUDA"):
            DurableHMGIIndex(cfg, os.path.join(tmpdir_, "d"), seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            recover(cfg, os.path.join(tmpdir_, "r"), seed=0)
        assert not os.listdir(tmpdir_)


class TestServingIntegration:
    def test_maintenance_driver_snapshot_pacing(self, tmpdir_):
        from repro_torch.serving.scheduler import MaintenanceDriver
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        ch.apply_ops(idx, ch.scripted_ops(), until=2)
        # maintenance interval 10 never fires in 6 ticks, so no new ops land
        # between the pacing snapshots: tick 3 writes, tick 6 is a no-op
        drv = MaintenanceDriver(idx, budget_rows=64, interval=10,
                                snapshot_interval=3)
        for _ in range(6):
            drv.tick()
        assert drv.snapshots == 1
        assert snapshot_steps(tmpdir_)
        idx.close()

    def test_plain_index_ignores_snapshot_pacing(self):
        from repro_torch.serving.scheduler import MaintenanceDriver
        cfg = _small_cfg()
        idx = HMGIIndex(cfg, seed=0, device=DEV)
        ch.apply_ops(idx, ch.scripted_ops(), until=1)
        drv = MaintenanceDriver(idx, budget_rows=64, interval=2,
                                snapshot_interval=1)
        for _ in range(4):
            drv.tick()                     # no snapshot() attr: no crash
        assert drv.snapshots == 0

    def test_engine_config_paces_snapshots(self, tmpdir_):
        """``EngineConfig.snapshot_interval`` reaches the engine's
        ``MaintenanceDriver``: its ticks snapshot the durable index."""
        from repro_torch.configs import smoke_config
        from repro_torch.models import lm
        from repro_torch.serving.engine import EngineConfig, RAGEngine
        cfg = _small_cfg()
        idx = DurableHMGIIndex(cfg, tmpdir_, seed=0, device=DEV)
        ch.apply_ops(idx, ch.scripted_ops(), until=2)
        lcfg = smoke_config("phi4-mini-3.8b").replace(dtype="float32")
        eng = RAGEngine(lcfg, lm.init_lm(lcfg, 0, device=DEV), idx,
                        EngineConfig(n_slots=2, max_seq=32,
                                     maintenance_interval=10,
                                     snapshot_interval=2), device=DEV)
        assert eng.maintenance.snapshot_interval == 2
        for _ in range(4):
            eng.tick()
        assert eng.maintenance.snapshots == 1 and snapshot_steps(tmpdir_)
        assert EngineConfig().snapshot_interval == 0
        idx.close()

