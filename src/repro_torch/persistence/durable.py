"""``DurableHMGIIndex`` — the log-then-apply facade — and ``recover``: the
port of ``repro.persistence.durable``.

Every mutating facade call (``ingest``/``insert``/``delete``/``maintain``/
``compact``/``maybe_repartition``/``set_attributes``) appends one op record
to the write-ahead log *before* applying it, so

    recover(cfg, data_dir)  =  latest valid snapshot + replay of the log
                               tail (seq > snapshot.last_seq)

yields search results **bit-identical** to an uninterrupted run of the
durable op prefix, no matter where the process died (the fault-injection
sweep in ``repro_torch.persistence.crash_harness`` asserts this at every
registered crash point).

Replay determinism (docs/DESIGN.md §7.2):

- All device math is deterministic given identical inputs — on the card
  too: the sums whose order atomics would leave open (k-means cluster
  sums, the hop operator's out-weights) run through the fixed-order
  segment-sum kernel — and op records carry the facade call's inputs
  byte-exactly: the live call consumes the same host arrays it logged.
- Random draws: every generator consumer (k-means builds, splits, NSW
  builds) runs inside a logged op, so the index's ``torch.Generator``
  advances identically on replay, and its state is snapshotted.
- Workload heat is the one signal written by *searches* (which are not
  logged): each op record stamps every modality's probe-heat counters at
  call time, and replay injects them (``WorkloadStats.load_hits``) before
  applying — the maintenance planner sees exactly the statistics it saw
  live. Search results never depend on heat, so recovered searches are
  bit-identical even though post-recovery heat restarts from the last op's
  stamp.
- Nested triggers (``insert`` auto-running ``maintain``) are *part of* the
  outer op: the reentrancy guard logs only top-level facade calls, so a
  maintenance drain is one atomic log record — replay re-derives the inner
  work, never half of it.
- A logged op holds the index's write lock from its append to the end of
  its apply, and ``snapshot()`` holds it throughout, so with concurrent
  writers the log's order is the order the ops were applied in.

Graceful degradation: a corrupt newest snapshot (bad leaf checksum, torn
manifest) falls back to the previous snapshot plus a longer replay, with a
warning surfaced in ``metrics()["recovery"]``. A config-fingerprint
mismatch raises instead — replaying state under a different config would
silently reinterpret bytes.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.checkpoint import CheckpointError
from repro_torch.core.index import HMGIIndex
from repro_torch.persistence import snapshot as snapshot_mod
from repro_torch.persistence.faultpoints import crash_point
from repro_torch.persistence.oplog import OpLog, OpRecord


def _np32(x, dtype):
    """The host array a call logs and then applies (a CUDA tensor is copied
    to the host first)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


class DurableHMGIIndex(HMGIIndex):
    """An ``HMGIIndex`` whose every mutation is durable.

    Reads (``search``/``hybrid_search``/``query``/``explain``/``metrics``)
    are inherited untouched — durability costs nothing on the read path.
    ``set_sparse_docs`` is snapshot-only state (not op-logged): re-set it
    after recovery or snapshot after setting it. device: as for
    ``HMGIIndex`` (None = the CUDA device).
    """

    def __init__(self, cfg, data_dir: str, mesh=None, seed: int = 0, *,
                 device=None, _recovering: bool = False):
        super().__init__(cfg, mesh=mesh, seed=seed, device=device)
        self.data_dir = data_dir
        self._op_state = threading.local()
        os.makedirs(data_dir, exist_ok=True)
        self._log = OpLog(snapshot_mod.wal_dir(data_dir),
                          sync_every=cfg.wal_sync_every)
        self._last_snapshot_seq = -1
        if not _recovering:
            if snapshot_mod.snapshot_steps(data_dir) or self._log.segments():
                raise ValueError(
                    f"{data_dir} already holds durable state — a fresh "
                    "DurableHMGIIndex would fork it; use "
                    "persistence.recover(cfg, data_dir) instead")
            self._log.open_for_append()

    # --------------------------------------------------------- log-then-apply
    @property
    def _in_op(self) -> bool:
        """The reentrancy guard: True on the thread inside a logged op (a
        per-thread flag, so another thread's write still gets logged)."""
        return getattr(self._op_state, "active", False)

    @_in_op.setter
    def _in_op(self, value: bool) -> None:
        self._op_state.active = value

    @contextlib.contextmanager
    def _logged_op(self, op: str, meta: dict, arrays: Dict[str, np.ndarray]):
        with self._write_lock:
            heat = {f"heat/{mod}": m.workload.hits_snapshot()
                    for mod, m in self.modalities.items()
                    if m.workload is not None}
            self._log.append(op, meta, {**arrays, **heat})
            self._in_op = True
            try:
                yield
            finally:
                self._in_op = False

    def ingest(self, embeddings, n_nodes, edges=None, build_nsw=False,
               node_attrs=None):
        if self._in_op:
            return super().ingest(embeddings, n_nodes, edges=edges,
                                  build_nsw=build_nsw, node_attrs=node_attrs)
        emb = {mod: (_np32(ids, np.int32), _np32(vecs, np.float32))
               for mod, (ids, vecs) in embeddings.items()}
        arrays: Dict[str, np.ndarray] = {}
        for mod, (ids, vecs) in emb.items():
            arrays[f"emb/{mod}/ids"] = ids
            arrays[f"emb/{mod}/vecs"] = vecs
        meta = {"n_nodes": int(n_nodes), "modality_order": list(emb),
                "build_nsw": bool(build_nsw), "edges": None, "attrs": None}
        if edges is not None:
            arrays["edges/src"] = _np32(edges[0], np.int32)
            arrays["edges/dst"] = _np32(edges[1], np.int32)
            meta["edges"] = {"type": len(edges) > 2, "weight": len(edges) > 3}
            if len(edges) > 2:
                arrays["edges/type"] = _np32(edges[2], np.int32)
            if len(edges) > 3:
                arrays["edges/weight"] = _np32(edges[3], np.float32)
        if node_attrs is not None:
            meta["attrs"] = list(node_attrs)
            for name, col in node_attrs.items():
                arrays[f"attr/{name}"] = _np32(col, np.int32)
        with self._logged_op("ingest", meta, arrays):
            return _apply_ingest(self, meta, arrays)

    def insert(self, modality, ids, vectors):
        if self._in_op:
            return super().insert(modality, ids, vectors)
        ids_np = _np32(ids, np.int32)
        v_np = _np32(vectors, np.float32)
        with self._logged_op("insert", {"modality": modality},
                             {"ids": ids_np, "vectors": v_np}):
            return super().insert(modality, ids_np, v_np)

    def delete(self, modality, ids):
        if self._in_op:
            return super().delete(modality, ids)
        ids_np = _np32(ids, np.int32)
        with self._logged_op("delete", {"modality": modality},
                             {"ids": ids_np}):
            return super().delete(modality, ids_np)

    def maintain(self, modality=None, budget=None, *, need_rows=0):
        if self._in_op:
            return super().maintain(modality, budget, need_rows=need_rows)
        meta = {"modality": modality,
                "budget": None if budget is None else int(budget),
                "need_rows": int(need_rows)}
        with self._logged_op("maintain", meta, {}):
            return super().maintain(modality, budget, need_rows=need_rows)

    def compact(self, modality):
        if self._in_op:
            return super().compact(modality)
        with self._logged_op("compact", {"modality": modality}, {}):
            return super().compact(modality)

    def maybe_repartition(self, modality):
        if self._in_op:
            return super().maybe_repartition(modality)
        with self._logged_op("repartition", {"modality": modality}, {}):
            return super().maybe_repartition(modality)

    def set_attributes(self, node_attrs):
        if self._in_op:
            return super().set_attributes(node_attrs)
        arrays = {f"attr/{name}": _np32(col, np.int32)
                  for name, col in node_attrs.items()}
        with self._logged_op("set_attributes",
                             {"columns": list(node_attrs)}, arrays):
            return super().set_attributes(
                {n: arrays[f"attr/{n}"] for n in node_attrs})

    # -------------------------------------------------------------- snapshots
    @property
    def last_seq(self) -> int:
        return self._log.last_seq

    def snapshot(self) -> Optional[str]:
        """Writes one versioned snapshot of the current state, prunes to
        ``cfg.snapshot_keep``, rotates the log, and unlinks segments no
        retained snapshot needs. No-op (returns None) when nothing changed
        since the last snapshot. Holds the write lock throughout: writers
        wait for the disk write, searches do not."""
        with self._write_lock:
            self._log.sync()
            seq = self._log.last_seq
            if seq == self._last_snapshot_seq:
                return None
            path = snapshot_mod.write_snapshot(self.data_dir, self, seq)
            self._last_snapshot_seq = seq
            floor = snapshot_mod.prune_snapshots(self.data_dir,
                                                 self.cfg.snapshot_keep)
            self._log.rotate(seq + 1)
            if floor is not None:
                self._log.gc(floor)
            return path

    def close(self) -> None:
        self._log.close()


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _apply_ingest(index: HMGIIndex, meta: dict, arrays: dict):
    emb = {mod: (arrays[f"emb/{mod}/ids"], arrays[f"emb/{mod}/vecs"])
           for mod in meta["modality_order"]}
    edges = None
    if meta["edges"] is not None:
        edges = [arrays["edges/src"], arrays["edges/dst"]]
        if meta["edges"]["type"]:
            edges.append(arrays["edges/type"])
        if meta["edges"]["weight"]:
            edges.append(arrays["edges/weight"])
        edges = tuple(edges)
    attrs = ({name: arrays[f"attr/{name}"] for name in meta["attrs"]}
             if meta["attrs"] is not None else None)
    return index.ingest(emb, meta["n_nodes"], edges=edges,
                        build_nsw=meta["build_nsw"], node_attrs=attrs)


def replay_op(index: HMGIIndex, rec: OpRecord) -> None:
    """Applies one logged op to ``index`` — the exact computation the live
    call ran: heat counters are injected first (the op's stamped values),
    and on a durable index the reentrancy guard is held so replay never
    re-logs. Works on a plain ``HMGIIndex`` too (the crash harness's golden
    runs replay the durable prefix into a fresh in-memory index)."""
    for key, arr in rec.arrays.items():
        if key.startswith("heat/"):
            m = index.modalities.get(key[len("heat/"):])
            if m is not None and m.workload is not None:
                m.workload.load_hits(arr)
    guarded = hasattr(index, "_in_op")
    prev = index._in_op if guarded else None
    if guarded:
        index._in_op = True
    try:
        op, meta = rec.op, rec.meta
        if op == "ingest":
            _apply_ingest(index, meta, rec.arrays)
        elif op == "insert":
            index.insert(meta["modality"], rec.arrays["ids"],
                         rec.arrays["vectors"])
        elif op == "delete":
            index.delete(meta["modality"], rec.arrays["ids"])
        elif op == "maintain":
            index.maintain(meta["modality"], meta["budget"],
                           need_rows=meta["need_rows"])
        elif op == "compact":
            index.compact(meta["modality"])
        elif op == "repartition":
            index.maybe_repartition(meta["modality"])
        elif op == "set_attributes":
            index.set_attributes({n: rec.arrays[f"attr/{n}"]
                                  for n in meta["columns"]})
        else:
            raise ValueError(f"unknown op record {op!r} at seq {rec.seq}")
    finally:
        if guarded:
            index._in_op = prev


def recover(cfg, data_dir: str, mesh=None, seed: int = 0, *,
            device=None) -> DurableHMGIIndex:
    """Restart-and-recover: latest valid snapshot + log-tail replay, onto
    ``device`` (None = the CUDA device, as for ``HMGIIndex``).

    Snapshots are tried newest-first; one that fails validation (corrupt
    leaf, torn manifest) is skipped with a warning and the previous one
    carries a longer replay — recovery only fails outright when the config
    fingerprint mismatches (wrong-config state must never load silently).
    With no usable snapshot the whole log replays from the initial ingest.
    The recovery trail (snapshot used, ops replayed, warnings) is surfaced
    in ``metrics()["recovery"]``; the stages are the ``snapshot.read``
    (files + crc32), ``recovery.restore`` (onto the device) and
    ``recovery.replay`` spans. mesh: as for ``HMGIIndex``; the sharded
    replica is derived state, built again by the first sharded search."""
    idx = DurableHMGIIndex(cfg, data_dir, mesh=mesh, seed=seed,
                           device=device, _recovering=True)
    warnings = []
    base_seq = 0
    loaded = None
    for step in reversed(snapshot_mod.snapshot_steps(data_dir)):
        try:
            tree, meta, last_seq = snapshot_mod.read_snapshot(
                data_dir, cfg, step)
        except CheckpointError as e:
            if "config fingerprint" in e.reason:
                raise
            warnings.append(f"snapshot step {step} unusable ({e.reason}); "
                            "falling back")
            continue
        with obs.span("recovery.restore") as sp:
            idx.restore_state(tree, meta)
            sp.fence([m.vectors for m in idx.modalities.values()])
        base_seq, loaded = last_seq, step
        break
    replayed = 0
    with obs.span("recovery.replay") as sp:
        for rec in idx._log.scan(min_seq=base_seq):
            crash_point("recover.mid_replay")
            replay_op(idx, rec)
            replayed += 1
        sp.fence([m.vectors for m in idx.modalities.values()])
    obs.gauge("recovery.replayed_ops").set(replayed)
    if idx._log.torn_tail:
        warnings.append(
            f"op log tail truncated after seq {idx._log.last_seq} "
            "(torn record from an interrupted append)")
    idx._log.open_for_append()
    # the snapshot can be ahead of every surviving log record (the segments
    # it superseded were GC'd; the fresh one is empty) — new appends must
    # continue after it, never reuse sequence numbers
    idx._log.last_seq = max(idx._log.last_seq, base_seq)
    idx._last_snapshot_seq = base_seq if loaded is not None else -1
    trail = (f"recovered from "
             + (f"snapshot step {loaded}" if loaded is not None
                else "empty (no usable snapshot)")
             + f" + {replayed} replayed ops (seq {base_seq} -> "
             + f"{idx._log.last_seq})")
    if warnings:
        trail += "; WARNING: " + "; ".join(warnings)
    idx._metrics["recovery"] = trail
    return idx
