"""Atomic, checksummed, async-capable checkpointing: the port's copy of the
reference's ``repro.checkpoint.checkpoint``, on torch tensors.

The files are the reference's, both ways: ``<dir>/step_<N>/`` holds one
``leaf_<i>.npy`` per leaf of the flattened tree (the reference's key paths
and leaf order: dict keys sorted, ``[i]`` for list and tuple items,
NamedTuple fields by name) and a ``manifest.json`` (step, per-leaf key,
file, shape, dtype name and crc32 of the stored bytes, and ``extra``).
Writes go to ``step_<N>.tmp`` and are atomically renamed, and every leaf
file, the manifest and the directories are fsync'd *before* the rename, so
a crashed writer never corrupts the latest checkpoint under power loss,
not just SIGKILL.

Leaves may be torch tensors on any device or numpy arrays. They are
written as their numpy bytes; ``bfloat16``, ``float8_e4m3fn`` and
``float8_e5m2``, which numpy cannot name, go as uint16/uint8 views with the
dtype name in the manifest, and come back as torch tensors of that dtype.

Restore validates structure, per-leaf key/shape/dtype, and the recorded
crc32 of each leaf's bytes; any mismatch raises ``CheckpointError`` naming
the offending leaf instead of silently reinterpreting bytes.
``restore_checkpoint(dir, like=None)`` restores the flat ``{key: leaf}``
dict straight from the manifest: numpy arrays with their stored dtypes
exactly, CPU torch tensors for the three dtypes above (the persistence
layer's snapshot path, where the shapes are not known up front). With
``like``, the leaves are torch tensors on the device of ``like``'s leaf.

``CheckpointManager`` adds: retention (keep last k), async background
writes (one thread) whose failures surface on the next ``save``/``wait``/
``restore_latest`` instead of vanishing in the pool, and
restore-latest-on-restart, which skips and garbage-collects leftover
``step_<N>.tmp`` dirs from crashed writers.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.persistence.faultpoints import crash_point

# dtypes numpy cannot name: stored as a same-width integer view, restored
# through the manifest's dtype name
EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}


class CheckpointError(RuntimeError):
    """A checkpoint failed validation. ``leaf`` names the offending leaf
    (or "" for manifest/structure-level failures), ``reason`` says why."""

    def __init__(self, path: str, leaf: str, reason: str):
        super().__init__(f"checkpoint {path}: "
                         + (f"leaf {leaf!r}: " if leaf else "") + reason)
        self.path = path
        self.leaf = leaf
        self.reason = reason


def to_savable(leaf) -> Tuple[np.ndarray, str]:
    """(C-contiguous host numpy array of the stored bytes, dtype name). A
    torch leaf is copied to the host; an exotic dtype becomes its integer
    view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in EXOTIC:
            return t.view(torch.int16 if t.element_size() == 2
                          else torch.uint8).numpy().view(EXOTIC[name][1]), name
        return t.numpy(), str(t.numpy().dtype)
    arr = np.ascontiguousarray(np.asarray(leaf))
    name = str(arr.dtype)
    if name in EXOTIC:
        return arr.view(EXOTIC[name][1]), name
    return arr, name


def from_saved(arr: np.ndarray, dtype_name: str):
    """The inverse of ``to_savable``: numpy as stored, or a CPU torch
    tensor of an exotic dtype."""
    if dtype_name in EXOTIC:
        wide = arr.view(np.int16) if arr.dtype.itemsize == 2 else arr
        return torch.from_numpy(np.ascontiguousarray(wide)).view(
            EXOTIC[dtype_name][0])
    return arr


def dtype_name(leaf) -> Optional[str]:
    """A leaf's dtype in the manifest's spelling (None when it has none)."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        return name if name in EXOTIC else str(
            torch.empty((), dtype=leaf.dtype).numpy().dtype)
    dt = getattr(leaf, "dtype", None)
    return None if dt is None else str(dt)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """[(key path, leaf)] in the reference's (``jax.tree_util``) order and
    spelling: dict keys sorted, ``[i]`` for list/tuple items, NamedTuple
    fields by name, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for name, sub in items:
        out.extend(flatten_with_paths(sub, prefix + (name,)))
    return out


def unflatten_like(like, leaves):
    """Rebuilds ``like``'s structure from an iterator of leaves taken in
    ``flatten_with_paths`` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: unflatten_like(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*[unflatten_like(getattr(like, f), leaves)
                            for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(v, leaves) for v in like)
    return next(leaves)


def host_copy(tree):
    """The tree with every leaf copied to the host (torch leaves as CPU
    tensors, numpy leaves as fresh arrays): a snapshot that later in-place
    writes to the live tensors cannot reach."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[host_copy(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write. Returns the final path.

    Durability order: leaf files -> manifest -> fsync(every file) ->
    fsync(tmp dir) -> rename -> fsync(parent dir). A crash anywhere before
    the rename leaves only a ``.tmp`` dir (skipped + GC'd by restore); a
    crash after it leaves a complete, checksummed checkpoint."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    written = []
    for i, (key, leaf) in enumerate(flatten_with_paths(tree)):
        savable, name = to_savable(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), savable)
        written.append(os.path.join(tmp, fname))
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(savable.shape),
             "dtype": name, "crc32": _leaf_crc(savable)})
        crash_point("snapshot.mid_write")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    written.append(os.path.join(tmp, "manifest.json"))
    for path in written:
        fsync_file(path)
    fsync_dir(tmp)
    crash_point("snapshot.pre_rename")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    crash_point("snapshot.post_rename")
    fsync_dir(directory)
    return final


def _load_manifest(path: str) -> dict:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointError(path, "", "missing manifest.json")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(path, "", f"unreadable manifest: {e}") from e


def _load_leaf(path: str, rec: dict):
    """One leaf, validated against its manifest record (shape + crc32)."""
    fpath = os.path.join(path, rec["file"])
    try:
        raw = np.load(fpath)
    except (OSError, ValueError) as e:
        raise CheckpointError(path, rec["key"], f"unreadable leaf: {e}") from e
    if "crc32" in rec and _leaf_crc(raw) != rec["crc32"]:
        raise CheckpointError(path, rec["key"], "crc32 mismatch (corrupt leaf)")
    arr = from_saved(raw, rec["dtype"])
    if list(arr.shape) != list(rec["shape"]):
        raise CheckpointError(
            path, rec["key"],
            f"stored shape {list(arr.shape)} != manifest {rec['shape']}")
    return arr


def restore_checkpoint(directory: str, like: Any = None,
                       step: Optional[int] = None
                       ) -> Tuple[Any, int, dict]:
    """Restores a checkpoint. step=None -> latest. Returns
    (tree, step, extra).

    like provided: restores into its structure, with every leaf validated
    (key order, shape, dtype, stored crc32) — any mismatch raises
    ``CheckpointError`` naming the offending leaf; each leaf comes back as
    a torch tensor on the device of ``like``'s leaf (the CPU for a numpy
    leaf). like=None: returns the flat ``{key: leaf}`` dict as written (the
    tree must have been a flat dict) — numpy arrays with their stored
    dtypes exactly, CPU torch tensors for the exotic dtypes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _load_manifest(path)

    if like is None:
        out = {}
        for rec in manifest["leaves"]:
            out[rec["key"]] = _load_leaf(path, rec)
        return out, manifest["step"], manifest.get("extra", {})

    leaves = flatten_with_paths(like)
    if len(leaves) != len(manifest["leaves"]):
        raise CheckpointError(
            path, "", f"pytree structure changed: {len(leaves)} leaves "
            f"expected, manifest has {len(manifest['leaves'])}")
    restored = []
    for (key, leaf), rec in zip(leaves, manifest["leaves"]):
        if key != rec["key"]:
            raise CheckpointError(
                path, rec["key"], f"leaf order mismatch: expected {key!r}")
        arr = _load_leaf(path, rec)
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise CheckpointError(
                path, key, f"shape {tuple(arr.shape)} != expected {want_shape}")
        want_dtype = dtype_name(leaf)
        if want_dtype is not None and rec["dtype"] != want_dtype:
            raise CheckpointError(
                path, key, f"dtype {rec['dtype']} != expected {want_dtype}")
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        restored.append(t.to(dev))
    tree = unflatten_like(like, iter(restored))
    return tree, manifest["step"], manifest.get("extra", {})


def checkpoint_steps(directory: str):
    """All complete checkpoint steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """Retention + async writes + restart contract."""

    def __init__(self, directory: str, keep: int = 3, async_writes: bool = True):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1) if async_writes else None
        self._pending = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _drain_pending_locked(self):
        """Joins the in-flight write; a stored failure surfaces here (and is
        cleared — one failed background write raises exactly once, on the
        next save/wait/restore_latest, instead of disappearing in the pool)."""
        if self._pending is not None:
            try:
                self._pending.result()
            except BaseException as e:  # noqa: BLE001 — surface, don't classify
                self._error = e
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                self.directory, "",
                f"background checkpoint write failed: {err}") from err

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        # copy to the host *now* (snapshot semantics: later in-place writes
        # to the live tensors must not reach the file), write in background
        snap = host_copy(tree)

        def work():
            save_checkpoint(self.directory, step, snap, extra)
            self._gc()

        if self._pool is None:
            work()
        else:
            with self._lock:
                self._drain_pending_locked()
                self._pending = self._pool.submit(work)

    def wait(self):
        with self._lock:
            self._drain_pending_locked()

    def restore_latest(self, like: Any = None):
        # under the lock throughout: no background write can start between
        # the drain and the tmp-dir GC (which would delete its .tmp dir
        # mid-write) or under the restore
        with self._lock:
            self._drain_pending_locked()
            self._gc_tmp()
            return restore_checkpoint(self.directory, like)

    def _gc_tmp(self):
        """Removes leftover ``step_<N>.tmp`` dirs (crashed writers). They are
        never a restore candidate — ``latest_step`` only matches completed
        dirs — but they hold disk and would shadow a same-step rewrite."""
        for name in os.listdir(self.directory):
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.directory))
            if m)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
