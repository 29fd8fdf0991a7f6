"""Partitioned ANNS — the search layer of the paper, on a CUDA device.

Two-level search: centroid scoring (small matmul) selects ``n_probe``
partitions per query; probed partitions are scored over their *quantized*
rows; exact top-k over the probed candidates. Cost ∝ n_probe·N/K + K
instead of N.

Storage is fixed-shape: (K, cap, d) quantized buckets + (K, cap) ids with -1
sentinels. ``IVFIndex.slab_view`` exposes the buckets as one flattened
(K·cap, d) int8 slab with per-row vmin/scale and -1 ids on empty slots;
partition ``p`` is the contiguous row block [p·cap, (p+1)·cap).

``impl`` selects the path: "kernel" (int8 indexes) hands the flat slab and
each query's probe list to the probe-scan kernel (``kernels/ivf_topk``),
which reads each probed partition in place once for all the queries that
probe it — no per-query gather of rows, no dequantization in memory — and
reduces them to per-chunk survivors (chunks cut at every probe's partition
end) that an exact rescore turns into the exact top-k. "einsum" is the fp32
dequant-then-einsum path kept for 4/16-bit storage and as a baseline;
"auto" takes the kernel whenever bits == 8.

Sharded execution path. ``shard_index`` re-lays the stable slab out as S
per-shard replicas with a leading shard dim: partition ``p``'s capacity
slots are dealt round-robin across shards (slot j -> shard j % S, local
slot j // S), the quantized rows move untouched (same int8 bytes, same
per-row vmin/scale), and the centroids are replicated. Every shard
therefore holds the same K partitions over a 1/S row slice, so a query's
probe list — scored against identical centroids — selects exactly the
single-device candidate set, split S ways. ``shard_placement`` puts shard
s on the mesh's device at db coordinate s (``repro_torch.sharding``), and
``search_sharded`` runs ``search`` itself on every shard (kernel or
einsum, with the same validity ∧ predicate mask pushdown), from one
Python loop, then gathers the S local top-k lists onto the mesh's first
device and merges them — bit-identical scores to the single-device scan
at any ``n_probe`` (each row's score is summed in a fixed order, whatever
its shard or chunk; ids may permute only where scores tie exactly).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.topk import top_k
from repro_torch.core import partitioner
from repro_torch.core.graph_store import mask_pass
from repro_torch.core.quantization import _unpack4, quantize
from repro_torch.kernels.ivf_topk.ops import scan_topk_probe
from repro_torch.kernels.ivf_topk.ref import NEG, pad_topk
from repro_torch.sharding import db_axes

# probe-path survivors: the max of every 16 consecutive rows of a partition
_CHUNK = 16


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor  # (K, d) fp32
    data: torch.Tensor       # (K, cap, d) int8 | (K, cap, d//2) int4-packed | bf16
    vmin: torch.Tensor       # (K, cap) fp32
    scale: torch.Tensor      # (K, cap) fp32
    ids: torch.Tensor        # (K, cap) int32, -1 = empty slot
    counts: torch.Tensor     # (K,) int32
    bits: int = 8

    @property
    def n_partitions(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.ids.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(int(a.numel()) * a.element_size()
                   for a in (self.centroids, self.data, self.vmin, self.scale, self.ids))

    def slab_view(self):
        """Flattened row-major view: (K·cap, d') data, (K·cap,) vmin/scale/ids.
        Reshape-only — no copy, no dequantization."""
        k, cap = self.ids.shape
        return (self.data.reshape(k * cap, -1), self.vmin.reshape(-1),
                self.scale.reshape(-1), self.ids.reshape(-1))

    def _replace(self, **kw) -> "IVFIndex":
        return dataclasses.replace(self, **kw)


def build(vectors: torch.Tensor, ids: torch.Tensor, *, n_partitions: int,
          capacity: Optional[int] = None, bits: int = 8, kmeans_iters: int = 16,
          centroids: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None
          ) -> Tuple[IVFIndex, torch.Tensor]:
    """Builds an IVF index. Returns (index, overflow_mask) — True rows did not
    fit their partition's capacity and belong in the delta store. Without
    ``centroids``, K-means runs first, seeded from ``generator``.

    Rows land in ascending input order within each partition (the
    reference's slots): a stable sort by partition gives each row its rank
    within its partition."""
    n, d = vectors.shape
    k = n_partitions
    dev = vectors.device
    cap = capacity or max(int(2 * n / k) + 1, 8)
    if centroids is None:
        centroids = partitioner.fit(vectors, k, kmeans_iters,
                                    generator=generator).centroids
    a = partitioner.assign(vectors, centroids).long()             # (N,)

    order = torch.sort(a, stable=True).indices
    counts_all = torch.bincount(a, minlength=k)
    start = torch.cumsum(counts_all, 0) - counts_all
    pos = torch.empty_like(a)
    pos[order] = torch.arange(n, device=dev) - start[a[order]]
    keep = pos < cap
    slot = (a * cap + pos)[keep]

    qv = quantize(vectors, bits)
    dstore = torch.zeros((k * cap,) + tuple(qv.data.shape[1:]),
                         dtype=qv.data.dtype, device=dev)
    dstore[slot] = qv.data[keep]
    vmin = torch.zeros((k * cap,), dtype=torch.float32, device=dev)
    vmin[slot] = qv.vmin[keep, 0]
    scale = torch.ones((k * cap,), dtype=torch.float32, device=dev)
    scale[slot] = qv.scale[keep, 0]
    id_store = torch.full((k * cap,), -1, dtype=torch.int32, device=dev)
    id_store[slot] = ids.to(torch.int32)[keep]
    counts = torch.clamp_max(counts_all, cap).to(torch.int32)

    idx = IVFIndex(
        centroids=centroids,
        data=dstore.reshape((k, cap) + tuple(qv.data.shape[1:])),
        vmin=vmin.reshape(k, cap),
        scale=scale.reshape(k, cap),
        ids=id_store.reshape(k, cap),
        counts=counts,
        bits=bits,
    )
    return idx, ~keep


# ---------------------------------------------------------------------------
# slot-level slab surgery (the maintenance executor's primitives)
# ---------------------------------------------------------------------------
# Rows always move as their stored bytes: identical int8 data + per-row
# vmin/scale ⇒ identical dequantized scores. ``rows`` are flat slab indices
# (partition p's slots are [p·cap, (p+1)·cap), matching ``slab_view``). Each
# returns a new index; the input is not modified.

def set_slots(index: IVFIndex, rows, data, vmin, scale, ids) -> IVFIndex:
    """Writes quantized rows (byte-identical) into the given flat slab slots
    and refreshes the per-partition counts."""
    k, cap = index.ids.shape
    dev = index.ids.device
    rows = torch.as_tensor(rows, device=dev).long()
    flat_ids = index.ids.reshape(-1).clone()
    flat_ids[rows] = torch.as_tensor(ids, device=dev).to(torch.int32)
    new_data = index.data.reshape(k * cap, -1).clone()
    new_data[rows] = data
    new_vmin = index.vmin.reshape(-1).clone()
    new_vmin[rows] = vmin
    new_scale = index.scale.reshape(-1).clone()
    new_scale[rows] = scale
    return index._replace(
        data=new_data.reshape(index.data.shape),
        vmin=new_vmin.reshape(k, cap),
        scale=new_scale.reshape(k, cap),
        ids=flat_ids.reshape(k, cap),
        counts=torch.sum(flat_ids.reshape(k, cap) >= 0, dim=1,
                         dtype=torch.int32))


def clear_slots(index: IVFIndex, rows) -> IVFIndex:
    """Empties the given flat slab slots (-1 id, zero data, unit scale)."""
    dev = index.ids.device
    rows = torch.as_tensor(rows, device=dev).long()
    n = rows.shape[0]
    return set_slots(
        index, rows,
        torch.zeros((n,) + tuple(index.data.shape[2:]), dtype=index.data.dtype,
                    device=dev),
        torch.zeros((n,), dtype=torch.float32, device=dev),
        torch.ones((n,), dtype=torch.float32, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev))


def gather_slots(index: IVFIndex, rows):
    """(data, vmin, scale, ids) of the given flat slab slots — the stored
    bytes, ready to be ``set_slots`` elsewhere byte-identically."""
    data, vmin, scale, ids = index.slab_view()
    rows = torch.as_tensor(rows, device=data.device).long()
    return data[rows], vmin[rows], scale[rows], ids[rows]


def _dequant_rows(index: IVFIndex, rows_data, rows_vmin, rows_scale):
    """rows_data: (..., d') quantized — returns (..., d) fp32."""
    if index.bits == 16:
        return rows_data.to(torch.float32)
    if index.bits == 8:
        q = rows_data.to(torch.float32) + 128.0
    else:  # 4-bit packed
        q = _unpack4(rows_data)
    return q * rows_scale[..., None] + rows_vmin[..., None]


def _resolve_impl(index: IVFIndex, impl: str) -> str:
    if impl == "auto":
        return "kernel" if index.bits == 8 else "einsum"
    if impl == "kernel" and index.bits != 8:
        raise ValueError(f"kernel probe path needs int8 storage, bits={index.bits}")
    return impl


def search(index: IVFIndex, queries: torch.Tensor, *, n_probe: int, k: int,
           query_block: int = 64, impl: str = "auto",
           probes: Optional[torch.Tensor] = None,
           node_pass: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores (Q, k), ids (Q, k)) — dot-product similarity, descending.

    impl="kernel" (default for int8) scans the probed partitions in place
    with the probe-scan kernel, every query in one launch. impl="einsum" is
    the gather-dequant-einsum path (4/16-bit storage, baseline), run
    ``query_block`` queries at a time to bound its (qb, P, cap, d) fp32
    intermediate.

    probes: optional precomputed (Q, n_probe) partition assignment.

    node_pass: optional (max_id+1,) bool predicate mask over global node
    ids — predicate *pushdown*: excluded rows are folded into the scan's
    validity mask (kernel bias / einsum -inf) before the top-k. Validity is
    per global id, so one (K·cap,) mask serves every query."""
    impl = _resolve_impl(index, impl)
    q = queries.to(torch.float32)
    nq = q.shape[0]
    n_probe = min(n_probe, index.n_partitions)
    if probes is None:
        probe, _ = partitioner.assign_topk(q, index.centroids, n_probe)  # (Q, P)
    else:
        probe = probes[:, :n_probe].to(torch.int32)
    cap = index.capacity

    def _row_valid(bids):
        """Slot occupancy ∧ predicate pushdown (pre-top-k filtering)."""
        if node_pass is not None:
            return mask_pass(node_pass, bids)
        return bids >= 0

    if impl == "kernel":
        slab_data, slab_vmin, slab_scale, slab_ids = index.slab_view()
        bias = torch.where(_row_valid(slab_ids), 0.0, NEG).to(torch.float32)
        vals, pos = scan_topk_probe(q, slab_data, slab_vmin, slab_scale, bias,
                                    probe, cap, k=k, chunk=_CHUNK)
        pc = pos.clamp(min=0).long()
        srow = (torch.gather(probe, 1, pc // cap).long() * cap + pc % cap)
        ids = torch.where(pos >= 0, slab_ids[srow], -1)
        return vals, ids

    out_v, out_i = [], []
    for s in range(0, nq, query_block):
        qs, ps = q[s:s + query_block], probe[s:s + query_block].long()
        bids = index.ids[ps]                                        # (qb,P,cap)
        vecs = _dequant_rows(index, index.data[ps], index.vmin[ps],
                             index.scale[ps])                       # (qb,P,cap,d)
        scores = torch.einsum("qd,qpcd->qpc", qs, vecs)
        scores = torch.where(_row_valid(bids), scores, float("-inf"))
        flat = scores.reshape(qs.shape[0], -1)
        fids = bids.reshape(qs.shape[0], -1)
        vals, pos = top_k(flat, min(k, flat.shape[1]))
        ids = torch.where(torch.isfinite(vals), torch.gather(fids, 1, pos), -1)
        vals, ids = pad_topk(vals, ids, k)
        out_v.append(vals)
        out_i.append(ids)
    return torch.cat(out_v), torch.cat(out_i)


def brute_force(vectors: torch.Tensor, valid: torch.Tensor, ids: torch.Tensor,
                queries: torch.Tensor, *, k: int):
    """Monolithic-baseline / delta-store scoring: exact matmul + top-k."""
    scores = queries.to(torch.float32) @ vectors.to(torch.float32).T
    scores = torch.where(valid[None, :], scores, float("-inf"))
    vals, pos = top_k(scores, min(k, vectors.shape[0]))
    return vals, ids[pos]


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Exact merge of two descending top-k lists. Assumes disjoint id sets."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    vals, pos = top_k(s, k)
    return vals, torch.gather(i, -1, pos)


def dedup_merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge of possibly-overlapping top-k lists: keeps one entry per id —
    the first in a stable descending sort, so the higher score, and the
    ``a`` side on an exact tie."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    i = torch.gather(i, -1, order)
    # mask entries whose id appeared at any earlier (higher-score) position
    n = s.shape[-1]
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool, device=s.device),
                         diagonal=-1)
    is_dup = ((i[..., :, None] == i[..., None, :]) & earlier).any(dim=-1)
    s = torch.where(is_dup | (i < 0), float("-inf"), s)
    vals, pos = top_k(s, k)
    return vals, torch.gather(i, -1, pos)


# ---------------------------------------------------------------------------
# row-sharded layout and search
# ---------------------------------------------------------------------------

_FIELDS = ("centroids", "data", "vmin", "scale", "ids", "counts")


def shard_index(index: IVFIndex, n_shards: int) -> IVFIndex:
    """Re-lays the stable store out for ``n_shards``-way row-parallel search.

    Returns an ``IVFIndex`` on the input's device whose every leaf carries
    a leading shard dim (S, ...): partition ``p``'s capacity slots are
    dealt round-robin (slot j -> shard j % S, local slot j // S — builds
    pack live rows into the low slots, so live rows spread evenly) over
    ``cap_l = ceil(cap / S)`` local slots, the tail padded with id -1,
    data 0, vmin 0 and scale 1; the quantized rows are moved without
    re-quantization, the centroids replicated, and ``counts`` is (S, K).
    ``search_sharded`` over this layout is score-bit-identical to
    ``search`` at any ``n_probe``. The input is not modified."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    k, cap = index.ids.shape
    cap_l = -(-cap // n_shards)

    def deal(a, fill):
        # local slot l of shard s is global slot l·S + s
        out = torch.full((n_shards, k, cap_l) + tuple(a.shape[2:]), fill,
                         dtype=a.dtype, device=a.device)
        for s in range(n_shards):
            part = a[:, s::n_shards]
            out[s, :, :part.shape[1]] = part
        return out

    ids = deal(index.ids, -1)
    return IVFIndex(
        centroids=index.centroids.repeat(n_shards, 1, 1),
        data=deal(index.data, 0),
        vmin=deal(index.vmin, 0.0),
        scale=deal(index.scale, 1.0),
        ids=ids,
        counts=torch.sum(ids >= 0, dim=2, dtype=torch.int32),
        bits=index.bits,
    )


def shard_devices(mesh) -> Tuple[torch.device, ...]:
    """The device of each row shard: shard s at db coordinate s (the db
    axes in row-major order, ``sharding.db_axes``), coordinate 0 on every
    other axis."""
    axes = db_axes(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for s in range(int(np.prod(sizes, dtype=np.int64))):
        coords = np.unravel_index(s, sizes) if sizes else ()
        out.append(mesh.device_at(dict(zip(axes, map(int, coords)))))
    return tuple(out)


def shard_placement(mesh):
    """Placement of ``shard_index`` layouts over ``mesh``: returns
    ``place(sharded) -> (IVFIndex, ...)``, shard s's local index on the
    mesh's device at db coordinate s. Where every shard's device is the
    layout's own (one device, repeated), the locals are views of the
    stacked leaves; otherwise each is its own copy, so the stacked layout
    can be freed. With no mesh every shard stays on the layout's device
    (the reference leaves such a layout where it is)."""
    devs = None if mesh is None else shard_devices(mesh)

    def place(sharded: IVFIndex) -> Tuple[IVFIndex, ...]:
        n = sharded.ids.shape[0]
        devs_ = (sharded.ids.device,) * n if devs is None else devs
        if n != len(devs_):
            raise ValueError(f"a {n}-shard layout over a mesh of "
                             f"{len(devs_)} db shards")
        copy = any(d != sharded.ids.device for d in devs_)
        return tuple(
            IVFIndex(**{f: getattr(sharded, f)[s].to(devs_[s], copy=copy)
                        for f in _FIELDS}, bits=sharded.bits)
            for s in range(n))
    return place


def _on(t: Optional[torch.Tensor], dev: torch.device):
    return None if t is None else t.to(dev)


def search_sharded(index: Union[IVFIndex, Sequence[IVFIndex]],
                   queries: torch.Tensor, mesh, *, n_probe: int, k: int,
                   query_block: int = 64, impl: str = "auto",
                   probes: Optional[torch.Tensor] = None,
                   node_pass: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded search: ``index`` is a ``shard_index`` layout (leading
    shard dim per leaf) or the tuple ``shard_placement(mesh)`` made of
    it; queries, ``probes`` and the optional ``node_pass``
    predicate-or-visibility mask are replicated to every shard. Each shard
    runs ``search`` itself (same kernel/einsum selection, same pre-top-k
    mask pushdown, same -inf/-1 padding) on its own device, launched from
    one loop (asynchronous: distinct cards overlap); the S local (Q, k)
    lists are gathered onto the mesh's first device, concatenated in shard
    order, and one top-k merges them. Local ids are global node ids, so
    they are unique across shards. Without ``probes`` the centroids are
    scored once, on the first shard (every shard holds the same ones).
    Returns (scores (Q, k), ids (Q, k)) on the mesh's first device."""
    shards = (shard_placement(mesh)(index) if isinstance(index, IVFIndex)
              else tuple(index))
    if len(shards) != len(shard_devices(mesh)):
        raise ValueError(f"{len(shards)} shards over a mesh of "
                         f"{len(shard_devices(mesh))} db shards")
    dev0 = shards[0].ids.device
    q = queries.to(torch.float32)
    if probes is None:
        n_probe = min(n_probe, shards[0].n_partitions)
        probes, _ = partitioner.assign_topk(q.to(dev0), shards[0].centroids,
                                            n_probe)
    parts = []
    for loc in shards:
        dev = loc.ids.device
        parts.append(search(loc, _on(q, dev), n_probe=n_probe, k=k,
                            query_block=query_block, impl=impl,
                            probes=_on(probes, dev),
                            node_pass=_on(node_pass, dev)))
    allv = torch.cat([v.to(dev0) for v, _ in parts], dim=1)    # (Q, S·k)
    alli = torch.cat([i.to(dev0) for _, i in parts], dim=1)
    mv, pos = top_k(allv, k)
    mi = torch.gather(alli, 1, pos)
    # shards pad ragged tails with (-inf, -1): never let a pad slot of one
    # shard surface another's id through the merge
    return mv, torch.where(torch.isfinite(mv), mi, -1)
