"""Versioned full-state snapshots of an ``HMGIIndex``, via the checkpoint
substrate: the port of ``repro.persistence.snapshot``.

A snapshot is one atomically-renamed checkpoint directory
(``<data_dir>/snapshots/step_<seq>/``) holding the index's complete
``state_tree`` — quantized slabs byte-identical, centroids (incl. parked
sentinels), delta + staleness bits, graph CSR, attributes, MVCC
tombstone/superseded bits, partition stats, workload heat, generator state
— with per-leaf crc32 checksums and a manifest ``extra`` carrying:

- ``last_seq`` — the op-log sequence number this snapshot reflects; replay
  resumes at ``last_seq + 1``
- ``config_fingerprint`` — sha256 over the sorted config dict (the same
  hash as the reference's for the same config); recovery refuses to load
  state under a different config (a changed quantization width or
  partition count would silently reinterpret bytes)
- ``meta`` — the structural metadata ``state_tree`` emitted

``state_tree`` hands out the index's own tensors, and an update rewrites
master rows in place, so ``write_snapshot`` copies the tree to the host
under the index's write lock (the ``snapshot.to_host`` span) before it
writes. Snapshots restore through ``restore_checkpoint(like=None)``:
host arrays come back with their exact stored dtypes and
``HMGIIndex.restore_state`` re-materialises device state, the generator
state included, so a restored index is bit-identical to the snapshotted
one on every search path and draws the same random numbers next.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Optional, Tuple

from repro_torch import obs
from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               checkpoint_steps, host_copy,
                                               restore_checkpoint,
                                               save_checkpoint)

SNAP_SUBDIR = "snapshots"
WAL_SUBDIR = "wal"


def config_fingerprint(cfg) -> str:
    """Stable hash of the full config: any field change (quant bits,
    partition count, delta capacity, ...) changes the fingerprint."""
    d = dataclasses.asdict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def snapshot_dir(data_dir: str) -> str:
    return os.path.join(data_dir, SNAP_SUBDIR)


def wal_dir(data_dir: str) -> str:
    return os.path.join(data_dir, WAL_SUBDIR)


def write_snapshot(data_dir: str, index, last_seq: int) -> str:
    """One snapshot at step ``last_seq``. Atomic (tmp + fsync + rename)."""
    with obs.span("snapshot.write"):
        with index._write_lock, obs.span("snapshot.to_host"):
            tree, meta = index.state_tree()
            tree = host_copy(tree)
        extra = {"last_seq": int(last_seq), "meta": meta,
                 "config_fingerprint": config_fingerprint(index.cfg)}
        return save_checkpoint(snapshot_dir(data_dir), int(last_seq), tree,
                               extra)


def read_snapshot(data_dir: str, cfg, step: int) -> Tuple[dict, dict, int]:
    """Loads snapshot ``step`` -> (tree, meta, last_seq), validating every
    leaf checksum and the config fingerprint. Raises ``CheckpointError``
    naming the offending leaf on any mismatch."""
    sdir = snapshot_dir(data_dir)
    with obs.span("snapshot.read"):
        tree, _, extra = restore_checkpoint(sdir, like=None, step=step)
    want = config_fingerprint(cfg)
    got = extra.get("config_fingerprint")
    if got != want:
        raise CheckpointError(
            os.path.join(sdir, f"step_{step:08d}"), "",
            f"config fingerprint mismatch: snapshot {got!r} vs current "
            f"{want!r} — the stored state was built under a different config")
    return tree, extra["meta"], int(extra["last_seq"])


def snapshot_steps(data_dir: str):
    """Complete snapshot steps, ascending (each step = its last_seq)."""
    return checkpoint_steps(snapshot_dir(data_dir))


def prune_snapshots(data_dir: str, keep: int) -> Optional[int]:
    """Deletes all but the newest ``keep`` snapshots. Returns the oldest
    *retained* step — the log-GC floor: records ≤ it are unreachable from
    every retained snapshot and may be unlinked."""
    steps = snapshot_steps(data_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(snapshot_dir(data_dir), f"step_{s:08d}"),
                      ignore_errors=True)
    kept = steps[-keep:] if keep else []
    return kept[0] if kept else None
