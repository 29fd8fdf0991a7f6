"""Kill-and-recover fault-injection harness for the durable index lifecycle:
the port of the reference's ``tools/crash_harness.py`` (the same op script,
golden prefix and bit-identity assertion).

For each registered crash point (``faultpoints.POINTS``) the harness:

1. runs a child process applying a fixed, deterministic op script to a
   ``DurableHMGIIndex`` with the fault point armed via ``HMGI_FAULTPOINT``
   — the child dies with ``os._exit(137)`` (SIGKILL semantics: no flush,
   no atexit, no finally) at the durability boundary;
2. recovers the data dir in-process and reads the recovered ``last_seq`` D;
3. builds a *golden* index by applying the first D logged ops of the same
   script (plus the interleaved searches that precede them — workload heat
   must match too) to a fresh in-memory ``HMGIIndex``;
4. asserts ``search`` and ``hybrid_search`` results are **bit-identical**
   (scores and ids, byte for byte) between recovered and golden.

``recover.*`` points crash the *recovery* instead: the child runs clean,
a second child dies mid-replay, and the harness asserts the next recovery
still matches golden (replay is read-only until the final log truncation,
so a crashed recovery is always re-runnable).

Usage (from the repository root, ``PYTHONPATH=src``):
    python -m repro_torch.persistence.crash_harness --sweep   # on the card
    python -m repro_torch.persistence.crash_harness --sweep --device cpu
    python -m repro_torch.persistence.crash_harness --point wal.pre_append
    ... --child --data-dir D                                    # (internal)
Without ``--data-dir`` each point runs in a fresh temporary directory,
removed afterwards.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.configs.base import HMGIConfig

_SRC = str(Path(__file__).resolve().parents[2])


def make_cfg() -> HMGIConfig:
    return HMGIConfig(modalities=("text", "image"), dim=12,
                      n_partitions=4, n_probe=4, kmeans_iters=4,
                      delta_capacity=64, use_nsw_refine=True,
                      snapshot_keep=2)


def queries() -> np.ndarray:
    return np.random.default_rng(99).standard_normal((4, 12)).astype(np.float32)


def scripted_ops():
    """Deterministic op script. ``("op", ...)`` entries are logged (one WAL
    record each, in order); ``search``/``snapshot`` entries are not logged
    but matter — searches move workload heat, snapshots set the recovery
    base. The script covers stable + delta + post-maintenance states and
    leaves a replay tail after the last snapshot."""
    rng = np.random.default_rng(7)
    n, d = 160, 12
    emb = {m: (np.arange(n, dtype=np.int32),
               rng.standard_normal((n, d)).astype(np.float32))
           for m in ("text", "image")}
    edges = (rng.integers(0, n, 400).astype(np.int32),
             rng.integers(0, n, 400).astype(np.int32))
    attrs = {"cat": rng.integers(0, 4, n).astype(np.int32)}
    ins = lambda lo, hi: (np.arange(lo, hi, dtype=np.int32),
                          rng.standard_normal((hi - lo, d)).astype(np.float32))
    return [
        ("ingest", emb, n, edges, attrs),                       # seq 1
        ("search", "text"), ("search", "image"),
        ("insert", "text", *ins(160, 180)),                     # seq 2
        ("search", "text"),
        ("delete", "text", np.arange(3, dtype=np.int32)),       # seq 3
        ("maintain",),                                          # seq 4
        ("snapshot",),
        ("insert", "image", *ins(180, 200)),                    # seq 5
        ("compact", "text"),                                    # seq 6
        ("search", "image"),
        ("insert", "text", *ins(200, 212)),                     # seq 7
        ("snapshot",),
        ("insert", "text", *ins(212, 224)),                     # seq 8
        ("delete", "image", np.arange(8, dtype=np.int32)),      # seq 9
        ("maintain",),                                          # seq 10
    ]


def apply_ops(index, ops, until=None):
    """Applies script entries to ``index`` in order, stopping once ``until``
    logged ops have been applied (searches past that point are skipped too —
    the recovered index's heat is the stamp of the last replayed record)."""
    q = queries()
    done = 0
    for entry in ops:
        kind = entry[0]
        if kind == "search":
            index.search(q, entry[1], k=5)
            continue
        if kind == "snapshot":
            if hasattr(index, "snapshot"):
                index.snapshot()
            continue
        if until is not None and done >= until:
            break
        if kind == "ingest":
            _, emb, n, edges, attrs = entry
            index.ingest(emb, n, edges=edges, build_nsw=True,
                         node_attrs=attrs)
        elif kind == "insert":
            index.insert(entry[1], entry[2], entry[3])
        elif kind == "delete":
            index.delete(entry[1], entry[2])
        elif kind == "maintain":
            index.maintain()
        elif kind == "compact":
            index.compact(entry[1])
        else:
            raise ValueError(kind)
        done += 1
    return done


def golden_index(cfg, d: int, device=None):
    """Fresh in-memory index after the first ``d`` logged ops."""
    from repro_torch.core.index import HMGIIndex
    idx = HMGIIndex(cfg, seed=0, device=device)
    apply_ops(idx, scripted_ops(), until=d)
    return idx


def _same_bytes(a, b) -> bool:
    return all(x.shape == y.shape and x.dtype == y.dtype
               and x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(a, b))


def assert_bit_identical(recovered, golden, label: str):
    q = queries()
    for mod in ("text", "image"):
        r = recovered.search(q, mod, k=8)
        g = golden.search(q, mod, k=8)
        if not _same_bytes(r, g):
            raise AssertionError(f"{label}: search({mod}) diverged:\n"
                                 f"  recovered ids {r[1][0].tolist()}\n"
                                 f"  golden    ids {g[1][0].tolist()}")
        r = recovered.hybrid_search(q, mod, k=8)
        g = golden.hybrid_search(q, mod, k=8)
        if not _same_bytes(r, g):
            raise AssertionError(f"{label}: hybrid_search({mod}) diverged")


# hits chosen so every point fires after meaningful state exists (e.g.
# wal.pre_rotate hit 1 is the constructor's first segment open; hit 2 is
# the first snapshot's rotation)
DEFAULT_HITS = {
    "wal.pre_append": 5,
    "wal.post_append": 5,
    "wal.pre_rotate": 2,
    "wal.pre_gc": 1,
    "wal.post_gc": 1,
    "snapshot.mid_write": 3,
    "snapshot.pre_rename": 1,
    "snapshot.post_rename": 1,
    "recover.mid_replay": 2,
}


def run_child(data_dir: str, recover_only: bool, env_point: Optional[str],
              device: Optional[str] = None):
    env = dict(os.environ)
    env.pop("HMGI_FAULTPOINT", None)
    if env_point:
        env["HMGI_FAULTPOINT"] = env_point
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "repro_torch.persistence.crash_harness",
           "--child", "--data-dir", data_dir]
    if recover_only:
        cmd.append("--recover-only")
    if device:
        cmd += ["--device", device]
    return subprocess.run(cmd, env=env, capture_output=True, text=True)


def check_point(point: str, data_dir: str, hits: Optional[int] = None,
                device: Optional[str] = None) -> str:
    """One kill-and-recover cycle for ``point``. Returns a summary line;
    raises on any mismatch."""
    from repro_torch.persistence import recover
    hits = DEFAULT_HITS[point] if hits is None else hits
    shutil.rmtree(data_dir, ignore_errors=True)
    cfg = make_cfg()
    if point.startswith("recover."):
        clean = run_child(data_dir, recover_only=False, env_point=None,
                          device=device)
        if clean.returncode != 0:
            raise AssertionError(f"clean child failed:\n{clean.stderr[-2000:]}")
        crashed = run_child(data_dir, recover_only=True,
                            env_point=f"{point}:{hits}", device=device)
    else:
        crashed = run_child(data_dir, recover_only=False,
                            env_point=f"{point}:{hits}", device=device)
    if crashed.returncode != 137:
        raise AssertionError(
            f"{point}: child exited {crashed.returncode}, expected 137 "
            f"(fault never fired?)\n{crashed.stderr[-2000:]}")
    idx = recover(cfg, data_dir, seed=0, device=device)
    d = idx.last_seq
    idx.close()
    # recover() is also what a restarted server runs — compare a *fresh*
    # recovery (the one above validated re-runnability after the crash)
    idx = recover(cfg, data_dir, seed=0, device=device)
    golden = golden_index(cfg, d, device=device)
    assert_bit_identical(idx, golden, point)
    trail = idx.metrics().get("recovery", "")
    idx.close()
    return f"{point}: killed at hit {hits}, recovered {d} ops — OK [{trail}]"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--recover-only", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--point")
    ap.add_argument("--hits", type=int, default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    if args.child:
        from repro_torch.persistence import DurableHMGIIndex, recover
        cfg = make_cfg()
        if args.recover_only:
            idx = recover(cfg, args.data_dir, seed=0, device=args.device)
        else:
            idx = DurableHMGIIndex(cfg, args.data_dir, seed=0,
                                   device=args.device)
            apply_ops(idx, scripted_ops())
        idx.close()
        return

    from repro_torch.persistence.faultpoints import POINTS
    points = list(POINTS) if args.sweep else [args.point]
    if not points[0]:
        ap.error("--point or --sweep required")
    root = args.data_dir or tempfile.mkdtemp(prefix="hmgi_crash_")
    failures = []
    try:
        for p in points:
            try:
                print(check_point(p, root, args.hits, args.device), flush=True)
            except AssertionError as e:
                failures.append(p)
                print(f"FAIL {p}: {e}", flush=True)
    finally:
        if args.data_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    if failures:
        sys.exit(f"{len(failures)} crash point(s) failed: {failures}")
    print(f"all {len(points)} crash point(s): clean recovery, "
          "bit-identical results")


if __name__ == "__main__":
    main()
