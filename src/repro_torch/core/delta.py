"""MVCC delta store (paper §3.5): insertions/updates/deletions land in a
fixed-capacity buffer; queries hybridise ANNS-on-stable with a scan-on-delta;
compaction merges the delta into the IVF partitions without a full rebuild.

Versioning: every write bumps ``version`` and stamps the rows it writes with
that counter (``row_version``). Visibility rules per read:
  stable row visible  iff  not tombstoned and not superseded
  delta  row visible  iff  not tombstoned and no newer delta version of the
                           same id exists (latest-version-wins)
``superseded`` marks ids whose latest version lives in the delta (an update =
supersede(old) + insert(new)); the write-time ``stale`` bit covers the
delta-vs-delta case. Compaction folds the latest versions back into the
stable index and clears both.

Scan path: rows are quantized to int8 at insert time (mirroring the stable
slab layout), so the delta scan runs through the shared-slab scan kernel
with chunk = 1; the top (k + margin) quantized survivors are then rescored
exactly against the fp32 master rows.

Every function returns a new ``DeltaStore`` and leaves its input as it was
(the fields it changes are copied; the others are shared).

``search_with_delta_sharded`` is the same read over a row-sharded stable
store (``ivf.shard_index``): per-shard masked probe scans and their
cross-shard merge, then the one replicated delta scan.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.common.params import resolve_device
from repro_torch.common.reduce import row_dot
from repro_torch.common.topk import top_k
from repro_torch.core import ivf as ivf_mod
from repro_torch.core.graph_store import mask_pass
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.quantization import quantize
from repro_torch.kernels.ivf_topk.ops import scan_topk_quantized
from repro_torch.kernels.ivf_topk.ref import pad_topk

# default extra quantized survivors rescored in fp32 before the final top-k
# (HMGIConfig.delta_rescore_margin overrides per index)
_RESCORE_MARGIN = 16


class DeltaStore(NamedTuple):
    vectors: torch.Tensor      # (cap, d) fp32 — master rows (compaction, rescore)
    qdata: torch.Tensor        # (cap, d) int8 — kernel-scan mirror (centred)
    qvmin: torch.Tensor        # (cap,) fp32 — per-row affine dequant terms
    qscale: torch.Tensor       # (cap,) fp32
    ids: torch.Tensor          # (cap,) int32, -1 empty
    row_version: torch.Tensor  # (cap,) int32 — MVCC audit stamp of the writing insert
    stale: torch.Tensor        # (cap,) bool — a newer delta version of this id exists
    count: torch.Tensor        # () int32
    version: torch.Tensor      # () int32 — MVCC write counter
    tombstones: torch.Tensor   # (max_ids,) bool — user deletes
    superseded: torch.Tensor   # (max_ids,) bool — stale stable rows (updates)


def init(capacity: int, dim: int, max_ids: int, device=None) -> DeltaStore:
    """An empty store on ``device`` (None = the CUDA device)."""
    device = resolve_device(device, "delta.init")
    def z(shape, dtype, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)
    return DeltaStore(
        vectors=z((capacity, dim), torch.float32),
        qdata=z((capacity, dim), torch.int8),
        qvmin=z((capacity,), torch.float32),
        qscale=z((capacity,), torch.float32, 1.0),
        ids=z((capacity,), torch.int32, -1),
        row_version=z((capacity,), torch.int32, -1),
        stale=z((capacity,), torch.bool, False),
        count=z((), torch.int32),
        version=z((), torch.int32),
        tombstones=z((max_ids,), torch.bool, False),
        superseded=z((max_ids,), torch.bool, False),
    )


def _clip_ids(delta: DeltaStore, ids: torch.Tensor) -> torch.Tensor:
    return ids.clamp(0, delta.tombstones.shape[0] - 1).long()


def insert(delta: DeltaStore, vecs: torch.Tensor, new_ids: torch.Tensor) -> DeltaStore:
    """Appends a batch (rows past the capacity are dropped — callers
    grow/compact first, see ``free_slots``/``grow``). Rows are quantized
    here, stamped with the current write version, and the latest-version
    ``stale`` bit is maintained at write time. Clears tombstones for
    re-inserted ids."""
    cap = delta.vectors.shape[0]
    n = vecs.shape[0]
    dev = delta.vectors.device
    if n == 0:
        return delta._replace(version=delta.version + 1)
    new_ids = new_ids.to(torch.int32)
    base = int(delta.count)
    n_fit = max(0, min(n, cap - base))
    fits = torch.arange(n, device=dev) < n_fit
    slots = torch.arange(base, base + n_fit, device=dev)
    v32 = vecs.to(torch.float32)
    qv = quantize(v32, 8)

    def put(field, values):
        out = field.clone()
        out[slots] = values[:n_fit]
        return out
    vectors = put(delta.vectors, v32)
    qdata = put(delta.qdata, qv.data)
    qvmin = put(delta.qvmin, qv.vmin[:, 0])
    qscale = put(delta.qscale, qv.scale[:, 0])
    ids = put(delta.ids, new_ids)
    rv = put(delta.row_version, delta.version.expand(n).to(torch.int32))
    # latest-version-wins, maintained at write time (reads pay nothing):
    # existing rows sharing an id with an *actually written* batch row go
    # stale, as does any batch row with a later same-id row in the batch.
    # Sort-based — no (cap, n) or (n, n) intermediates.
    ids_eff = torch.where(fits, new_ids, -2)
    sb = torch.sort(ids_eff).values
    pos = torch.searchsorted(sb, delta.ids).clamp(0, n - 1)
    hit_old = (sb[pos] == delta.ids) & (delta.ids >= 0)
    stale = delta.stale | hit_old
    # a stable sort keeps batch order within equal ids: a sorted element
    # followed by its own id is not the last (newest) version
    order = torch.sort(ids_eff, stable=True).indices
    srt = ids_eff[order]
    not_last = torch.cat([srt[:-1] == srt[1:],
                          torch.zeros((1,), dtype=torch.bool, device=dev)])
    batch_stale = torch.zeros((n,), dtype=torch.bool, device=dev)
    batch_stale[order] = not_last
    stale[slots] = batch_stale[:n_fit]
    ts = delta.tombstones.clone()
    ts[_clip_ids(delta, new_ids)] = False
    return DeltaStore(vectors, qdata, qvmin, qscale, ids, rv, stale,
                      delta.count + n_fit, delta.version + 1, ts,
                      delta.superseded)


def supersede(delta: DeltaStore, old_ids: torch.Tensor) -> DeltaStore:
    """Marks stable rows stale (the update path: supersede + insert)."""
    sp = delta.superseded.clone()
    sp[_clip_ids(delta, old_ids)] = True
    return delta._replace(superseded=sp, version=delta.version + 1)


def delete(delta: DeltaStore, dead_ids: torch.Tensor) -> DeltaStore:
    ts = delta.tombstones.clone()
    ts[_clip_ids(delta, dead_ids)] = True
    return delta._replace(tombstones=ts, version=delta.version + 1)


def free_slots(delta: DeltaStore) -> int:
    return int(delta.vectors.shape[0] - int(delta.count))


def insert_grow(delta: DeltaStore, vecs: torch.Tensor,
                new_ids: torch.Tensor) -> DeltaStore:
    """Insert that never drops rows: grows the store first when the batch
    exceeds the free slots (2x headroom so the result isn't born at the
    compaction threshold)."""
    n = int(vecs.shape[0])
    if free_slots(delta) < n:
        delta = grow(delta, int(delta.count) + 2 * n + 1)
    return insert(delta, vecs, new_ids)


def grow(delta: DeltaStore, min_capacity: int) -> DeltaStore:
    """Capacity growth (copy into a larger store), doubling."""
    cap = delta.vectors.shape[0]
    if min_capacity <= cap:
        return delta
    new_cap = cap
    while new_cap < min_capacity:
        new_cap *= 2
    pad = new_cap - cap
    F = torch.nn.functional
    return delta._replace(
        vectors=F.pad(delta.vectors, (0, 0, 0, pad)),
        qdata=F.pad(delta.qdata, (0, 0, 0, pad)),
        qvmin=F.pad(delta.qvmin, (0, pad)),
        qscale=F.pad(delta.qscale, (0, pad), value=1.0),
        ids=F.pad(delta.ids, (0, pad), value=-1),
        row_version=F.pad(delta.row_version, (0, pad), value=-1),
        stale=F.pad(delta.stale, (0, pad)),
    )


def _latest_version_mask(delta: DeltaStore) -> torch.Tensor:
    """(cap,) bool: True where the row is the newest delta version of its id
    (the write-time ``stale`` bit keeps this O(cap))."""
    return (delta.ids >= 0) & ~delta.stale


def _scan_delta(delta: DeltaStore, queries: torch.Tensor, *, k: int,
                margin: int = _RESCORE_MARGIN,
                node_pass: Optional[torch.Tensor] = None):
    """Kernel scan over the quantized delta rows + exact fp32 rescore of the
    top (k + margin) survivors. chunk=1 makes the survivor ordering exact
    over quantized scores. Results match brute force exactly whenever the
    delta holds ≤ k + margin live rows.

    Visibility: tombstones out, stale versions out, rows failing
    ``node_pass`` out — before the top-k, like the stable probe path."""
    cap = delta.ids.shape[0]
    valid = _latest_version_mask(delta) & ~delta.tombstones[_clip_ids(delta, delta.ids)]
    if node_pass is not None:
        valid = valid & mask_pass(node_pass, delta.ids)
    k_scan = min(cap, k + margin)
    q = queries.to(torch.float32)
    qvals, qrows = scan_topk_quantized(q, delta.qdata, delta.qvmin,
                                       delta.qscale, valid, k=k_scan, chunk=1)
    rows = qrows.clamp(0, cap - 1).long()
    vecs = delta.vectors[rows]                                # (Q, k_scan, d)
    exact = row_dot(q[:, None, :], vecs)
    exact = torch.where((qrows >= 0) & torch.isfinite(qvals), exact,
                        float("-inf"))
    kk = min(k, exact.shape[1])
    vals, pos = top_k(exact, kk)
    di = torch.gather(delta.ids[rows], 1, pos)
    di = torch.where(torch.isfinite(vals), di, -1)
    return pad_topk(vals, di, k)


def _stable_visibility(delta: DeltaStore, node_pass: Optional[torch.Tensor],
                       mvcc_filter: bool) -> Optional[torch.Tensor]:
    """The stable scan's pre-top-k validity mask: MVCC visibility
    (tombstones | superseded out) ∧ the optional predicate. The one
    spelling shared by the single-device and sharded paths.
    mvcc_filter=False is the caller-asserted never-mutated fast path."""
    if not mvcc_filter:
        return node_pass
    live = ~(delta.tombstones | delta.superseded)
    return live if node_pass is None else live & node_pass


def search_with_delta(index: IVFIndex, delta: DeltaStore, queries: torch.Tensor, *,
                      n_probe: int, k: int,
                      rescore_margin: int = _RESCORE_MARGIN,
                      probes: Optional[torch.Tensor] = None,
                      node_pass: Optional[torch.Tensor] = None,
                      impl: str = "auto",
                      mvcc_filter: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-ANNS ∪ delta-kernel-scan, visibility-filtered, dedup-merged.

    MVCC visibility is pushed into the stable scan's validity mask exactly
    like the predicate — *pre* top-k — so a scan at full probe matches brute
    force over the visible corpus."""
    visible = _stable_visibility(delta, node_pass, mvcc_filter)
    sv, si = ivf_mod.search(index, queries, n_probe=n_probe, k=k,
                            probes=probes, node_pass=visible, impl=impl)
    dv, di = _scan_delta(delta, queries, k=k, margin=rescore_margin,
                         node_pass=node_pass)
    mv, mi = ivf_mod.dedup_merge_topk(sv, si, dv, di, k)
    # -inf slots are "no result": don't leak a masked (e.g. tombstoned) id
    return mv, torch.where(torch.isfinite(mv), mi, -1)


def search_with_delta_sharded(sharded, delta: DeltaStore,
                              queries: torch.Tensor, mesh, *, n_probe: int,
                              k: int, rescore_margin: int = _RESCORE_MARGIN,
                              probes: Optional[torch.Tensor] = None,
                              node_pass: Optional[torch.Tensor] = None,
                              impl: str = "auto", mvcc_filter: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``search_with_delta`` over a row-sharded stable store: per-shard
    masked probes + cross-shard merge via ``ivf.search_sharded``, one
    replicated delta scan, dedup-merge.

    ``sharded`` is an ``ivf.shard_index`` layout or its placed shards
    (``ivf.shard_placement``). The visibility and predicate masks are
    built by ``_stable_visibility``, the single-device path's own
    spelling, and pushed into every shard's scan pre-top-k, so the two
    paths' results cannot drift apart. The delta is replicated state: it
    is scanned once, after the merge, on its own device."""
    visible = _stable_visibility(delta, node_pass, mvcc_filter)
    with obs.span("sharded.scan") as sp:
        sv, si = sp.fence(ivf_mod.search_sharded(
            sharded, queries, mesh, n_probe=n_probe, k=k, probes=probes,
            node_pass=visible, impl=impl))
    # everything after the per-shard scans is the sharded path's extra
    # cost over single-device execution
    with obs.span("sharded.merge") as sp:
        dev = delta.ids.device
        sv, si = sv.to(dev), si.to(dev)
        dv, di = _scan_delta(delta, queries, k=k, margin=rescore_margin,
                             node_pass=node_pass)
        mv, mi = ivf_mod.dedup_merge_topk(sv, si, dv, di, k)
        return sp.fence((mv, torch.where(torch.isfinite(mv), mi, -1)))


def should_compact(delta: DeltaStore, threshold: float = 0.5) -> bool:
    """True when the delta's append watermark reaches threshold·capacity."""
    return int(delta.count) >= int(threshold * delta.vectors.shape[0])


# ---------------------------------------------------------------------------
# incremental drain (bounded-work compaction steps)
# ---------------------------------------------------------------------------

def live_slots(delta: DeltaStore) -> np.ndarray:
    """Host: slot indices (ascending — oldest write first) of rows visible
    to the delta scan: latest version per id, not tombstoned."""
    ids = delta.ids.cpu().numpy()
    tomb = delta.tombstones.cpu().numpy()
    ok = _latest_version_mask(delta).cpu().numpy() \
        & ~tomb[np.clip(ids, 0, tomb.shape[0] - 1)]
    return np.where(ok)[0]


def rebuild_keep(delta: DeltaStore, keep_slots, clear_superseded_ids=None
                 ) -> DeltaStore:
    """Fresh store holding only ``keep_slots``'s rows, re-packed from slot 0
    (stored bytes move untouched). Tombstones carry over; the version stays
    monotone. ``clear_superseded_ids`` marks ids whose latest version just
    moved into the stable store."""
    sp = delta.superseded
    dev = delta.vectors.device
    if clear_superseded_ids is not None and len(clear_superseded_ids):
        sp = sp.clone()
        sp[_clip_ids(delta, torch.as_tensor(
            np.asarray(clear_superseded_ids, np.int64), device=dev))] = False
    cap = delta.vectors.shape[0]
    keep = torch.as_tensor(np.asarray(keep_slots, np.int64), device=dev)
    n = int(keep.numel())
    fresh = init(cap, delta.vectors.shape[1], delta.tombstones.shape[0], dev)

    def put(field, src):
        out = field.clone()
        out[:n] = src[keep]
        return out
    return DeltaStore(
        vectors=put(fresh.vectors, delta.vectors),
        qdata=put(fresh.qdata, delta.qdata),
        qvmin=put(fresh.qvmin, delta.qvmin),
        qscale=put(fresh.qscale, delta.qscale),
        ids=put(fresh.ids, delta.ids),
        row_version=put(fresh.row_version, delta.row_version),
        stale=fresh.stale,                  # kept rows are one-per-id live
        count=torch.tensor(n, dtype=torch.int32, device=dev),
        version=delta.version + 1,
        tombstones=delta.tombstones,
        superseded=sp,
    )


def compact(index: IVFIndex, delta: DeltaStore, all_vectors: torch.Tensor,
            all_ids: torch.Tensor) -> Tuple[IVFIndex, DeltaStore]:
    """Full synchronous compaction: merge live delta rows into the stable
    index by re-running the assignment against the *existing* centroids (no
    K-means refit). all_vectors/all_ids: the full corpus with one latest row
    per id; tombstoned rows keep their slots as empty (-1) rows, as in the
    reference. Returns (new_index, fresh_delta); rows that don't fit their
    partition are re-queued in the fresh delta, grown if needed."""
    live = ~delta.tombstones[_clip_ids(delta, all_ids)]
    vecs = torch.where(live[:, None], all_vectors, 0.0)
    ids = torch.where(live, all_ids.to(torch.int32), -1)
    new_index, overflow = ivf_mod.build(vecs, ids,
                                        n_partitions=index.n_partitions,
                                        capacity=index.capacity, bits=index.bits,
                                        centroids=index.centroids)
    over = overflow & live
    fresh = init(delta.vectors.shape[0], delta.vectors.shape[1],
                 delta.tombstones.shape[0], delta.vectors.device)
    fresh = fresh._replace(version=delta.version + 1, tombstones=delta.tombstones)
    if bool(over.any()):
        sel = torch.nonzero(over).flatten()
        fresh = insert_grow(fresh, all_vectors[sel], all_ids[sel])
    return new_index, fresh
