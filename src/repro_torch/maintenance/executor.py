"""Bounded-work executors for maintenance actions (the port of
``repro.maintenance.executor``).

Each function applies one ``cost_model.MaintenanceAction`` to a modality's
state (``m`` is the facade's ``ModalityIndex``, duck-typed: ``ivf``,
``delta``, ``vectors``, ``ids``) as slot surgery instead of a
stop-the-world rebuild:

- **compact_chunk** — drains a fixed-size chunk of live delta rows into the
  stable slab, each row placed by its *current* centroid assignment (an
  update whose vector moved must land where future probes will look for
  it; its old slot is cleared, or overwritten in place when the assigned
  partition is full — and the superseded bit clears either way). Rows move
  as their stored int8 bytes (the delta quantizes at insert with the same
  per-row affine scheme the slab uses), so the post-drain scan scores are
  exactly what a full ``delta.compact`` would produce for those rows. Rows
  that fit nowhere stay in the delta for a later step — never dropped.
- **merge_cold** — folds a cold partition's live rows byte-identically into
  the free slots of its nearest sibling; tombstoned/superseded rows are
  purged, not moved, and purged tombstones stay set (a deleted id must
  never resurrect). Survivors that don't fit the sibling go to the delta
  (fp32 master rows). The emptied partition's centroid is parked
  (``partitioner.parked_centroid``), freeing the slot for a future split.
- **split_hot** — K=2 local Lloyd's fit over the hot partition's stored
  (dequantized) members, then a byte-identical redistribution of those rows
  between the hot partition and a parked one (merging the coldest
  partition away first if none is parked). Only the hot partition's rows
  move.
- **recluster** — re-centers a drifted partition's centroid on the mean of
  its live members. No rows move; only future routing changes.

Every executor returns a result dict (``note`` for the report, plus
counters); ``apply`` dispatches. At full probe the visible corpus (stable
∪ delta under MVCC masks) is unchanged, except where an action changes a
row's *representation* on purpose (delta fp32 → stable int8 on drain,
stable int8 → delta fp32 on merge overflow).

Lookups over the whole slab or the whole master-id array (an update's old
slot, an id's master row, the free slots of a partition) run on the
index's device with a stable ``torch.sort`` and ``torch.searchsorted`` —
the answers of the reference's host ``argsort`` / ``searchsorted`` — and
only chunk-sized results come back to the host. The master rows
(``m.vectors``) are rewritten in place by updates, so every row this
module keeps is gathered (a copy), never a view.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import delta as delta_mod
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import partitioner
from repro_torch.core.cost_model import MaintenanceAction
from repro_torch.core.quantization import quantize
from repro_torch.maintenance.stats import PartitionStats


def apply(m, cfg, generator: Optional[torch.Generator],
          stats: PartitionStats, action: MaintenanceAction) -> Dict:
    if action.kind == "compact_chunk":
        # transfers always pad to the configured chunk width, even for a
        # planner-trimmed partial chunk: every drain step moves one shape
        return compact_chunk(m, stats, action.rows, pad_to=cfg.maint_chunk)
    if action.kind == "merge_cold":
        return merge_cold(m, stats, action.partition)
    if action.kind == "split_hot":
        return split_hot(m, cfg, generator, stats, action.partition)
    if action.kind == "recluster":
        return recluster(m, stats, action.partition)
    raise ValueError(f"unknown maintenance action {action.kind!r}")


def _dev_index(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def _flat_rows(ivf, p: int, occupied: bool) -> np.ndarray:
    """Flat slab row indices of partition ``p``'s occupied (or free) slots."""
    ids = ivf.ids[p]
    sel = (ids >= 0) if occupied else (ids < 0)
    return p * ivf.capacity + torch.nonzero(sel).flatten().cpu().numpy()


def _dead_at(m, gids: np.ndarray) -> np.ndarray:
    """(n,) bool: the ids' stable rows are hidden (tombstoned or
    superseded)."""
    d = m.delta
    g = _dev_index(gids, d.tombstones.device).clamp(0, d.tombstones.shape[0] - 1)
    return (d.tombstones[g] | d.superseded[g]).cpu().numpy()


def _lookup(keys: torch.Tensor, wanted: torch.Tensor):
    """For each of ``wanted``: (found, the lowest position in ``keys``
    holding it). A stable sort keeps equal keys in position order, so the
    left ``searchsorted`` hit is the first occurrence — the reference's
    ``argsort(kind="stable")`` + ``searchsorted``."""
    sorted_keys, order = torch.sort(keys, stable=True)
    pos = torch.searchsorted(sorted_keys, wanted.to(keys.dtype))
    pos = pos.clamp(max=max(keys.shape[0] - 1, 0))
    return sorted_keys[pos] == wanted, order[pos]


def _master_rows(m, gids: np.ndarray) -> torch.Tensor:
    """Global id -> row in the fp32 master array (``m.vectors``), on the
    device."""
    found, rows = _lookup(m.ids, _dev_index(gids, m.ids.device))
    assert bool(found.all()), "stable id missing a master row"
    return rows


def _mean_dist(rows: torch.Tensor, centroid: torch.Tensor) -> float:
    """Mean distance of ``rows`` to ``centroid`` (a partition's new
    baseline), on the device: only the mean comes back to the host."""
    if not rows.shape[0]:
        return 0.0
    return float(torch.linalg.vector_norm(rows - centroid, dim=-1).mean())


def _pad(x: np.ndarray, width: int) -> np.ndarray:
    """``x`` widened to ``width`` by repeating its first entry (an
    idempotent duplicate for the slot writes and clears below)."""
    out = np.full(width, x[0], np.int64)
    out[:x.size] = x
    return out


# --------------------------------------------------------------------- drain
def compact_chunk(m, stats: PartitionStats, chunk: int,
                  pad_to: int = 0) -> Dict:
    """One incremental compaction step: drain ≤ ``chunk`` live delta rows
    into the stable slab (see module doc for placement rules). ``pad_to``
    widens the padded device transfers beyond ``chunk`` (the facade passes
    ``cfg.maint_chunk``, so every step moves the same shapes)."""
    delta = m.delta
    live = delta_mod.live_slots(delta)
    used_before = int(delta.count)
    if live.size == 0:
        if used_before:
            # only dead weight left (stale versions, tombstone shadows):
            # reclaim the slots, nothing moves to stable
            m.delta = delta_mod.rebuild_keep(delta, np.empty(0, np.int64))
            return {"drained": 0, "reclaimed": used_before,
                    "ivf_changed": False,
                    "note": f"reclaimed {used_before} dead slots"}
        return {"drained": 0, "ivf_changed": False, "note": "empty delta"}

    dev = delta.ids.device
    take = live[:chunk]
    take_t = _dev_index(take, dev)
    d_ids_t = delta.ids[take_t]
    d_ids = d_ids_t.cpu().numpy()
    cap = m.ivf.capacity
    width = max(chunk, pad_to)

    # every drained row is placed by its *current* assignment (an update
    # may have moved the vector far from its old partition — leaving it in
    # place would make probe-limited queries for the new vector miss it)
    assign = partitioner.assign(delta.vectors[_dev_index(_pad(take, width),
                                                         dev)],
                                m.ivf.centroids)[:take.size].cpu().numpy()

    # an update's old stable slot: the in-place fallback (and, when the row
    # moves partitions, the slot to clear)
    slab_ids = m.ivf.ids.reshape(-1)
    found, first = _lookup(slab_ids, d_ids_t)
    has_slot = found.cpu().numpy()
    old_slot = np.where(has_slot, first.cpu().numpy(), -1).astype(np.int64)

    # the free slots of each assigned partition, in slot order: the j-th
    # free slot of partition p is found by a binary search over the running
    # count of p's free slots
    parts = np.unique(assign)
    free = m.ivf.ids[_dev_index(parts, dev)] < 0                 # (U, cap)
    n_free = free.sum(dim=1).cpu().numpy()
    rank = torch.cumsum(free, dim=1, dtype=torch.int32)
    jth = torch.arange(1, take.size + 1, dtype=torch.int32,
                       device=dev).expand(parts.size, take.size)
    free_pos = torch.searchsorted(rank, jth.contiguous()).cpu().numpy()

    target = np.full(d_ids.size, -1, np.int64)
    clear_old = np.zeros(d_ids.size, bool)
    for u, part in enumerate(parts):
        members = np.where(assign == part)[0]
        # already in the right partition: overwrite in place
        in_place = members[old_slot[members] // cap == part]
        in_place = in_place[old_slot[in_place] >= 0]
        target[in_place] = old_slot[in_place]
        rest = members[~np.isin(members, in_place)]
        n = min(int(n_free[u]), rest.size)
        target[rest[:n]] = part * cap + free_pos[u, :n]
        clear_old[rest[:n]] = old_slot[rest[:n]] >= 0
        # no free slot in the assigned partition: fall back to the old
        # slot (placement is recall policy, not correctness); rows with
        # neither stay in the delta for a later step — never dropped
        fb = rest[n:][old_slot[rest[n:]] >= 0]
        target[fb] = old_slot[fb]

    drained = target >= 0
    n_drained = int(drained.sum())
    if n_drained:
        co = old_slot[drained & clear_old]
        if co.size:
            # padded to the chunk width (duplicate clears are idempotent)
            m.ivf = ivf_mod.clear_slots(m.ivf, _pad(co, width))
        # fixed-width transfer: the tail re-writes slot target[0] with
        # its own bytes (idempotent duplicate)
        sel = _dev_index(_pad(take[drained], width), dev)
        tgt = _pad(target[drained], width)
        if m.ivf.bits == 8:
            # the delta's int8 mirror shares the slab's scheme: move bytes
            data, vmin, scale = (delta.qdata[sel], delta.qvmin[sel],
                                 delta.qscale[sel])
        else:
            # 4/16-bit slabs store a different layout than the delta's int8
            # mirror: re-quantize the fp32 master rows at the slab's width
            # (exactly what a full compact stores for these rows)
            qv = quantize(delta.vectors[sel], m.ivf.bits)
            data, vmin, scale = qv.data, qv.vmin[:, 0], qv.scale[:, 0]
        m.ivf = ivf_mod.set_slots(m.ivf, tgt, data, vmin, scale,
                                  delta.ids[sel])
        # the old slots held the superseded pre-update rows: overwritten or
        # cleared, that dead weight is gone
        part_old = old_slot[drained & has_slot] // cap
        np.subtract.at(stats.dead, part_old, 1)
        np.maximum(stats.dead, 0, out=stats.dead)
        stats.invalidate_slab()
    keep = np.setdiff1d(live, take[drained])
    # count ids whose superseded bit was actually SET (not just those with
    # a stable slot): an updated ingest-overflow row has the bit but no slot
    sup = delta.superseded
    gone = d_ids_t[torch.as_tensor(drained, device=dev)].long()
    n_cleared = int(sup[gone.clamp(0, sup.shape[0] - 1)].sum())
    m.delta = delta_mod.rebuild_keep(delta, keep,
                                     clear_superseded_ids=d_ids[drained])
    return {"drained": n_drained, "ivf_changed": n_drained > 0,
            "cleared_superseded": n_cleared,
            "left": int(keep.size),
            "note": (f"drained {n_drained} rows "
                     f"(delta {used_before}->{int(m.delta.count)})")}


# --------------------------------------------------------------------- merge
def _park(ivf, p: int):
    cents = ivf.centroids.clone()
    cents[p] = torch.as_tensor(partitioner.parked_centroid(cents.shape[1]),
                               device=cents.device)
    return ivf._replace(centroids=cents)


def merge_cold(m, stats: PartitionStats, p: int) -> Dict:
    """Folds partition ``p`` into its nearest live sibling and parks it."""
    ivf = m.ivf
    cents = ivf.centroids.cpu().numpy()
    parked = partitioner.parked_mask(cents)
    if parked[p]:
        return {"note": f"p={p} already parked", "moved": 0,
                "ivf_changed": False}
    siblings = [q for q in range(ivf.n_partitions) if q != p and not parked[q]]
    if not siblings:
        return {"note": "no live sibling", "moved": 0, "ivf_changed": False}
    d2 = np.sum((cents[siblings] - cents[p]) ** 2, axis=1)
    sib = siblings[int(np.argmin(d2))]

    rows_p = _flat_rows(ivf, p, occupied=True)
    gids = ivf.ids.reshape(-1)[_dev_index(rows_p, ivf.ids.device)]
    dead = _dead_at(m, gids.cpu().numpy())
    live_rows = rows_p[~dead]           # dead rows are purged, not moved
    # (purged tombstones stay set: the id must not resurrect; a purged
    # superseded row's latest version lives in the delta and its bit is
    # cleared when that row drains)

    free_sib = _flat_rows(ivf, sib, occupied=False)
    n_fit = min(free_sib.size, live_rows.size)
    if n_fit:
        data, vmin, scale, ids = ivf_mod.gather_slots(ivf, live_rows[:n_fit])
        ivf = ivf_mod.set_slots(ivf, free_sib[:n_fit], data, vmin, scale, ids)
    overflow = live_rows[n_fit:]
    if overflow.size:
        over_ids = m.ivf.ids.reshape(-1)[_dev_index(overflow, ivf.ids.device)]
        rows = _master_rows(m, over_ids.cpu().numpy())
        m.delta = delta_mod.insert_grow(m.delta, m.vectors[rows], over_ids)
    ivf = _park(ivf_mod.clear_slots(ivf, rows_p), p)
    m.ivf = ivf
    stats.reset_partition(p, 0.0, parked=True)
    stats.invalidate_slab()
    return {"moved": n_fit, "purged": int(dead.sum()), "ivf_changed": True,
            "overflow": int(overflow.size), "sibling": sib,
            "note": (f"p={p} -> p={sib}: moved {n_fit}, purged "
                     f"{int(dead.sum())} dead, {int(overflow.size)} to delta")}


# --------------------------------------------------------------------- split
def split_hot(m, cfg, generator: Optional[torch.Generator],
              stats: PartitionStats, hot: int, *,
              init_idx: Optional[torch.Tensor] = None) -> Dict:
    """Splits the hot partition's members across (hot, a freed partition)
    via a local K=2 fit (seeded from ``generator``, or at the member rows
    ``init_idx``). Merges the coldest partition away first when no parked
    slot is available."""
    parked = partitioner.parked_mask(m.ivf.centroids)
    merge_note = ""
    if parked.any():
        target = int(np.where(parked)[0][0])
    else:
        live = m.ivf.counts.cpu().numpy()
        others = [q for q in range(m.ivf.n_partitions) if q != hot]
        if not others:
            return {"note": "single partition, cannot split", "moved": 0,
                    "ivf_changed": False}
        target = min(others, key=lambda q: int(live[q]))
        res = merge_cold(m, stats, target)
        merge_note = f"; freed via {res['note']}"
        if not partitioner.parked_mask(m.ivf.centroids)[target]:
            return {"note": f"could not free a partition{merge_note}",
                    "moved": 0, "ivf_changed": True}

    ivf = m.ivf
    rows_all = _flat_rows(ivf, hot, occupied=True)
    gids = ivf.ids.reshape(-1)[_dev_index(rows_all, ivf.ids.device)]
    rows_h = rows_all[~_dead_at(m, gids.cpu().numpy())]
    # (dead rows are purged with the rewrite)
    if rows_h.size < 2:
        return {"note": f"p={hot} has <2 live rows{merge_note}", "moved": 0,
                "ivf_changed": bool(merge_note)}

    data, vmin, scale, ids = ivf_mod.gather_slots(ivf, rows_h)
    members = ivf_mod._dequant_rows(ivf, data, vmin, scale)
    cents2, sub_assign = partitioner.split_two(members, generator=generator,
                                               init_idx=init_idx)
    sub = sub_assign.cpu().numpy()
    if (sub == 0).all() or (sub == 1).all():
        # degenerate fit (duplicated members): treat as a recluster
        return recluster(m, stats, hot)

    cap = ivf.capacity
    ivf = ivf_mod.clear_slots(ivf, rows_all)
    halves = []
    groups = (np.where(sub == 0)[0], np.where(sub == 1)[0])
    for g, part in zip(groups, (hot, target)):
        sel = _dev_index(g, data.device)
        ivf = ivf_mod.set_slots(ivf, part * cap + np.arange(g.size),
                                data[sel], vmin[sel], scale[sel], ids[sel])
        halves.append(g.size)
    cents = ivf.centroids.clone()
    cents[hot], cents[target] = cents2[0], cents2[1]
    m.ivf = ivf._replace(centroids=cents)
    for g, part, c in zip(groups, (hot, target), (0, 1)):
        stats.reset_partition(part, _mean_dist(
            members[_dev_index(g, members.device)], cents2[c]),
            parked=False)
    stats.invalidate_slab()
    return {"moved": int(rows_h.size), "halves": tuple(halves),
            "ivf_changed": True,
            "target": target,
            "note": (f"p={hot} split {halves[0]}/{halves[1]} "
                     f"into p={target}{merge_note}")}


# ----------------------------------------------------------------- recluster
def recluster(m, stats: PartitionStats, p: int) -> Dict:
    """Re-centers partition ``p``'s centroid on its live members' mean (no
    row moves — a drifted centroid only mis-routes *future* probes/writes)."""
    ivf = m.ivf
    rows_p = _flat_rows(ivf, p, occupied=True)
    gids = ivf.ids.reshape(-1)[_dev_index(rows_p, ivf.ids.device)]
    rows_p = rows_p[~_dead_at(m, gids.cpu().numpy())]
    if rows_p.size == 0:
        return {"note": f"p={p} has no live rows", "moved": 0,
                "ivf_changed": False}
    data, vmin, scale, _ = ivf_mod.gather_slots(ivf, rows_p)
    members = ivf_mod._dequant_rows(ivf, data, vmin, scale)
    centroid = torch.mean(members, dim=0)
    cents = ivf.centroids.clone()
    cents[p] = centroid
    m.ivf = ivf._replace(centroids=cents)
    old = stats.baseline[p]
    stats.reset_partition(p, _mean_dist(members, centroid))
    return {"moved": 0, "members": int(rows_p.size), "ivf_changed": True,
            "note": (f"p={p} re-centered over {int(rows_p.size)} rows "
                     f"(baseline {old:.3f}->{stats.baseline[p]:.3f})")}
