"""GNN execution substrate of the port (``repro.models.gnn.common``):
``FlatGraph`` and the single-device engine ``LocalExec``.

The reference's ``LocalExec.push`` gathers both endpoints of every edge,
builds every message at once, masks them and segment-sums them into their
destinations. At ogbn-products scale (61.9 M edges) that holds several KB
of temporaries per edge, well over the card's 80 GB. The port's
``LocalExec`` instead sorts the valid edges by destination once, when it is
built (a stable sort; masked edges and destinations outside ``[0, N)`` are
dropped, as the reference's mask and drop rule zero them), keeps the CSR
``rowptr``, and runs ``push`` / ``push_attn`` over chunks of whole
destination segments of about ``chunk_edges`` edges each, cut at a
``rowptr`` boundary. A chunk's messages come out in sorted order, so the
segment-sum kernel reads them contiguously (no ``perm``) and writes output
rows ``[seg_lo, seg_hi)`` directly. Each output row is therefore summed by
one launch in one fixed order.

``msg_fn`` is not called per chunk but per block: the sorted edges are
cut into fixed blocks ``[k·block, (k+1)·block)`` (the last one padded with
copies of node 0), with ``block`` set by the graph alone (and a model's
declared widths, below), and a chunk takes its messages from the blocks it
overlaps (a block that two chunks share is computed once). A library GEMM
picks its kernel, and with it the order of its sums (a tile shape, a split
of K), from the shape of the product, so the same row can come out with
other bits in a product of another row count; the CPU's BLAS and
vectorised activations change path with the row count too. With every
edge computed in the same block at the same place whatever the chunks, its
message, and so the whole forward, has the same bits for every chunk
budget, on the card and on the CPU.

Under grad (training), ``push`` and ``push_attn`` are differentiable with
memory bounded by one message block: each block runs inside
``torch.utils.checkpoint`` (its per-edge temporaries, ~2.7 KB an edge for
EGNN, are dropped after the forward and recomputed one block at a time in
the backward), and each chunk goes through the differentiable segment sum,
which returns the chunk's own rows (assembled with one ``cat``). The
transposes of the two row gathers are not ``index_add_`` (atomics: the bits
would change from run to run on the card), nor a dense (N, Dp) gradient a
block that autograd would then add up. A call keeps one (N, Dp) gradient
buffer for its payload (``_GradBuffer``, zero-filled at the first block's
backward), and the blocks read the payload through a token,
``_GradSink``'s output. Each gather (``_GatherRows``) returns no gradient:
its backward adds its block's cotangents in place into the buffer, with
the in-place segment-sum kernel (``ops.segment_sum_csr_accumulate``) over
the rows the block touches only: by destination, the block's range of
destinations and its slice of ``rowptr`` (the edges are
destination-sorted); by source, its distinct sources, a CSR compacted from
a stable sort of the block's sources (``csr_by_row``). The engine runs the
sink's backward after every gather's, and it hands out the buffer as the
payload's gradient. The blocks are added in the engine's reverse creation
order, the same whatever the chunks, so a step's gradients have the same
bits for every chunk budget. Under ``no_grad`` (or when the payload takes
no gradient) the forward and its launches (one per chunk) are what they
were.

The sizes above are EGNN's. A model with wider rows declares its widths
with ``LocalExec.sized(edge_bytes, row_bytes)``, which returns the engine
with a block of at most ``MSG_BLOCK_BYTES`` of msg_fn temporaries (a power
of two: still set by the graph and the model alone, whatever the chunk
budget) and chunks of at most ``CHUNK_MSG_BYTES`` of messages, over the
same sort. A model's own row lookups (DimeNet's) go through
``sparse.segment.gather_rows``, whose transpose adds the cotangents into
the rows it touches with the in-place kernel too, so a step repeats bit
for bit.

Over a mesh the graph is a ``RingGraph`` (``to_ring``; ``pad_to_shards``
first where N does not divide by the shards), and ``run_flat`` runs the
reference's ``shard_map`` on one controller: each data shard's body in a
thread of its own (``collectives.spmd``), on that shard's n_loc node rows
on its device, with its ``RingShard`` (from the mesh-wide ``RingExec``
callers build once): R rotations of its block of the
payload (rendezvous with the other shards), each round a ``SortedEdges``
with the machinery above, the "model" split of a round's edges and its
``psum``; the loss sums ``psum``med over the data axes. S = 1 runs the
ring too.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.tree import tree_map
from repro_torch.kernels.segment_reduce import ops
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import Mesh, data_axes, require_mesh
from repro_torch.sparse import segment as seg
from repro_torch.sparse.segment import csr_by_row

# edges per chunk: the chunk's messages are held for the kernel (EGNN at
# d_hidden 64: 272 B per edge, 1.1 GB for 4 Mi edges)
DEFAULT_CHUNK_EDGES = 1 << 22
# rows of one msg_fn call at most: EGNN at d_hidden 64 holds ~2.7 KB of
# fp32 temporaries per row, ~2.8 GB for 1 Mi rows
MSG_BLOCK_EDGES = 1 << 20
# a model that declares its widths (``LocalExec.sized``): msg_fn
# temporaries of one block, and messages of one chunk, at most
MSG_BLOCK_BYTES = 16 << 30
CHUNK_MSG_BYTES = 1 << 30


@contextlib.contextmanager
def scaled_budgets(scale: float):
    """The four budgets above times ``scale`` while it is open, for engines
    built inside it (a power of two keeps the blocks' powers of two): the
    dry run's probes shrink a cell uniformly, nodes, edges, blocks and
    chunks alike, so that a probe runs the cell's blocks and chunks at a
    fraction of their rows (``launch/dryrun.py``)."""
    global DEFAULT_CHUNK_EDGES, MSG_BLOCK_EDGES, MSG_BLOCK_BYTES
    global CHUNK_MSG_BYTES
    saved = (DEFAULT_CHUNK_EDGES, MSG_BLOCK_EDGES, MSG_BLOCK_BYTES,
             CHUNK_MSG_BYTES)
    DEFAULT_CHUNK_EDGES, MSG_BLOCK_EDGES, MSG_BLOCK_BYTES, CHUNK_MSG_BYTES = (
        max(1, int(b * scale)) for b in saved)
    try:
        yield
    finally:
        (DEFAULT_CHUNK_EDGES, MSG_BLOCK_EDGES, MSG_BLOCK_BYTES,
         CHUNK_MSG_BYTES) = saved


class FlatGraph(NamedTuple):
    """Single-device flat layout: one graph as flat tensors, -1/False padded.
    A batch of graphs stacks each field along a leading B axis."""
    feats: torch.Tensor        # (N, F)
    positions: torch.Tensor    # (N, 3)
    edge_src: torch.Tensor     # (E,) int32
    edge_dst: torch.Tensor     # (E,) int32
    edge_mask: torch.Tensor    # (E,) bool
    node_mask: torch.Tensor    # (N,) bool
    labels: torch.Tensor       # (N,) int32

    @property
    def n_nodes(self) -> int:
        return self.feats.shape[0]


def chunk_bounds(rowptr: np.ndarray, chunk_edges: int) -> List[int]:
    """Segment boundaries ``[0, b1, ..., N]`` of consecutive chunks: each
    chunk takes whole segments while its edges stay within
    ``chunk_edges``, and at least one segment (a hub larger than the
    budget is a chunk of its own)."""
    n = len(rowptr) - 1
    bounds, lo = [0], 0
    while lo < n:
        hi = int(np.searchsorted(rowptr, rowptr[lo] + chunk_edges,
                                 side="right")) - 1
        lo = min(max(hi, lo + 1), n)
        bounds.append(lo)
    return bounds


class _GradBuffer:
    """One call's gradient of its payload: an (N, Dp) tensor of the
    payload's dtype, zero-filled at the first ``add``, into which each
    block's gather transposes add in place (the module docstring)."""

    def __init__(self, payload: torch.Tensor):
        self.shape, self.dtype = tuple(payload.shape), payload.dtype
        self.device = payload.device
        self.buf = None

    def add(self, grad, rowptr, perm=None, rows=None, seg_lo=0) -> None:
        """Adds the CSR-grouped sums of ``grad``'s rows into their rows."""
        if self.buf is None:
            self.buf = torch.zeros(self.shape, dtype=self.dtype,
                                   device=self.device)
        dev = self.device              # a ring's block may sit elsewhere

        def on(t):
            return None if t is None else t.to(dev)

        ops.segment_sum_csr_accumulate(on(grad).contiguous(), on(rowptr),
                                       on(perm), out=self.buf, rows=on(rows),
                                       seg_lo=seg_lo)

    def take(self) -> torch.Tensor:
        buf, self.buf = self.buf, None
        if buf is None:
            buf = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return buf


class _GradSink(torch.autograd.Function):
    """The identity on the payload: its output is the token the gathers
    read. Its backward runs after every gather's backward (they all hang
    off the token) and hands out the buffer as the payload's gradient."""

    @staticmethod
    def forward(ctx, payload, buffer):
        ctx.set_materialize_grads(False)
        ctx.buffer = buffer
        return payload.view_as(payload)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        buf = ctx.buffer.take()
        return (buf if grad is None else buf.add_(grad)), None


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose transpose is ``add(grad)``: it
    adds the cotangents into a ``_GradBuffer`` and returns no gradient for
    ``table``, which is a ``_GradSink``'s token."""

    @staticmethod
    def forward(ctx, table, idx, add):
        ctx.add = add
        return table.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ctx.add(grad)
        return None, None, None


class SortedEdges:
    """One edge set sorted by destination once (see the module docstring):
    ``src`` rows of a source table into ``n`` destination rows. ``chunks``
    lists ``(seg_lo, seg_hi, e0, e1, rowptr)`` with ``rowptr`` rebased to
    the chunk's first edge; ``block`` is the row count of every ``msg_fn``
    call: the valid edges rounded up to a power of two, at most
    ``MSG_BLOCK_EDGES`` (or ``sized``'s). ``LocalExec`` is one over a
    graph's own nodes; ``RingShard`` holds one for each round of its
    shard."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 mask: torch.Tensor, n: int,
                 chunk_edges: Optional[int] = None):
        if chunk_edges is None:
            chunk_edges = DEFAULT_CHUNK_EDGES
        if chunk_edges < 1:
            raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
        self.n = n
        self.chunk_edges = chunk_edges
        ok = mask & (dst >= 0) & (dst < self.n)
        dst_ok = dst[ok].to(torch.int64)
        sorted_dst, order = torch.sort(dst_ok, stable=True)
        self.src = src[ok][order].to(torch.int32)
        self.dst = sorted_dst.to(torch.int32)
        bounds = torch.arange(self.n + 1, device=dst.device)
        self.rowptr = torch.searchsorted(sorted_dst, bounds).to(torch.int32)
        del sorted_dst, order, dst_ok
        self.block = self._max_block = min(
            MSG_BLOCK_EDGES, 1 << max(0, self.n_edges - 1).bit_length())
        self._rp_host = self.rowptr.cpu().numpy().astype(np.int64)
        self._chunk_lists = {}          # chunk_edges -> chunks, shared
        self.chunks = self._chunks(chunk_edges)

    def _chunks(self, chunk_edges: int
                ) -> List[Tuple[int, int, int, int, torch.Tensor]]:
        if chunk_edges not in self._chunk_lists:
            rp, out = self._rp_host, []
            seg_b = chunk_bounds(rp, chunk_edges)
            for lo, hi in zip(seg_b[:-1], seg_b[1:]):
                e0, e1 = int(rp[lo]), int(rp[hi])
                out.append((lo, hi, e0, e1,
                            (self.rowptr[lo:hi + 1] - e0).contiguous()))
            self._chunk_lists[chunk_edges] = out
        return self._chunk_lists[chunk_edges]

    def sized(self, edge_bytes: int, row_bytes: int) -> "SortedEdges":
        """This engine for a model whose msg_fn holds ``edge_bytes`` of
        temporaries per edge and whose messages are ``row_bytes`` wide: its
        block the largest power of two that keeps a block's temporaries
        within ``MSG_BLOCK_BYTES`` (at most the default block), its chunk
        budget cut to ``CHUNK_MSG_BYTES`` of messages. It shares the sort
        and the graph."""
        ex = copy.copy(self)
        cap = max(1, MSG_BLOCK_BYTES // max(1, edge_bytes))
        ex.block = min(self._max_block, 1 << (cap.bit_length() - 1))
        ex.chunk_edges = min(self.chunk_edges,
                             max(1, CHUNK_MSG_BYTES // max(1, row_bytes)))
        ex.chunks = self._chunks(ex.chunk_edges)
        return ex

    @property
    def n_edges(self) -> int:
        """Valid edges (those that carry a message)."""
        return int(self.src.numel())

    def _block_edges(self, k: int) -> Tuple[int, int]:
        """[a, b): the valid sorted edges of block k."""
        a = k * self.block
        return a, min(a + self.block, self.n_edges)

    def _dst_csr(self, k: int):
        """Block k's edges grouped by destination over the rows its edges
        reach, ``[lo, hi)``: ``(rowptr (hi - lo + 1,) int32 rebased to the
        block, lo)``, the block's slice of ``rowptr`` (no perm; the padding
        rows past its edges are in no segment)."""
        a, b = self._block_edges(k)
        lo = int(np.searchsorted(self._rp_host, a, side="right")) - 1
        hi = int(np.searchsorted(self._rp_host, b, side="left"))
        return self.rowptr[lo:hi + 1].clamp(a, b) - a, lo

    def _src_csr(self, k: int):
        """Block k's edges grouped by source over its distinct sources:
        ``csr_by_row`` of its sources."""
        a, b = self._block_edges(k)
        return csr_by_row(self.src[a:b])

    def _add_dst(self, buffer: _GradBuffer, k: int, grad) -> None:
        """Adds block k's cotangents into its destinations' rows."""
        a, b = self._block_edges(k)
        if b <= a:                  # a graph without edges: nothing to add
            return
        rowptr, lo = self._dst_csr(k)
        buffer.add(grad, rowptr, seg_lo=lo)

    def _add_src(self, buffer: _GradBuffer, k: int, grad) -> None:
        """Adds block k's cotangents into its distinct sources' rows."""
        rowptr, perm, rows = self._src_csr(k)
        buffer.add(grad, rowptr, perm, rows)

    def _block_rows(self, fn, node_payload: torch.Tensor, k: int,
                    buffer=None, src_table=None, src_buffer=None):
        """``fn(src rows, dst rows)`` of sorted-edge block k, padded to
        ``block`` rows with copies of row 0. The destination rows come from
        ``node_payload``, the source rows from ``src_table`` (None: the
        same). Under grad the block is checkpointed; with a ``buffer``
        (``node_payload`` is then its sink's token, ``src_table`` the
        token of ``src_buffer``'s sink) its gathers are ``_GatherRows``."""
        a = k * self.block
        src = self.src[a:a + self.block]
        dst = self.dst[a:a + self.block]
        if src.numel() < self.block:
            pad = src.new_zeros(self.block - src.numel())
            src, dst = torch.cat([src, pad]), torch.cat([dst, pad])
        if src_table is None:
            src_table, src_buffer = node_payload, buffer
        if not torch.is_grad_enabled():
            return fn(src_table.index_select(0, src),
                      node_payload.index_select(0, dst))

        def run(payload, src_payload):
            if buffer is None:
                return fn(src_payload.index_select(0, src),
                          payload.index_select(0, dst))
            return fn(_GatherRows.apply(
                          src_payload, src,
                          lambda g: self._add_src(src_buffer, k, g)),
                      _GatherRows.apply(
                          payload, dst, lambda g: self._add_dst(buffer, k, g)))

        return checkpoint(run, node_payload, src_table, use_reentrant=False)

    @staticmethod
    def _sink(node_payload: torch.Tensor):
        """(what the blocks read, the gradient buffer or None): under grad,
        a payload that takes a gradient is read through a ``_GradSink``.
        The token carries its buffer (``grad_buffer``)."""
        if not (torch.is_grad_enabled() and node_payload.requires_grad):
            return node_payload, None
        buffer = _GradBuffer(node_payload)
        token = _GradSink.apply(node_payload, buffer)
        token.grad_buffer = buffer
        return token, buffer

    def messages(self, fn, node_payload: torch.Tensor, buffer=None,
                 src_table=None, src_buffer=None):
        """Yields ``(chunk, rows)`` for every chunk in order: ``rows`` is
        ``fn(src rows, dst rows)`` of the chunk's edges (Ec, ...), taken
        from the fixed blocks of sorted edges (the module docstring says
        why). fn must compute each row from its own edge alone. With a
        ``buffer``, ``node_payload`` is its sink's token (``_sink``).
        ``src_table`` / ``src_buffer``: where the source rows come from,
        when not from ``node_payload`` (``_block_rows``)."""
        t = self.block
        last_k, last = -1, None
        for chunk in self.chunks:
            e0, e1 = chunk[2], chunk[3]
            parts = []
            # an empty chunk still takes a zero-row slice of a block, for
            # the shape of the result
            ks = range(e0 // t, -(-e1 // t)) if e1 > e0 else [
                min(e0 // t, max(0, self.n_edges - 1) // t)]
            for k in ks:
                if k != last_k:
                    last_k, last = k, self._block_rows(
                        fn, node_payload, k, buffer, src_table, src_buffer)
                a = k * t
                parts.append(last[max(e0, a) - a:min(e1, a + t) - a])
            yield chunk, parts[0] if len(parts) == 1 else torch.cat(parts)

    def push(self, node_payload: torch.Tensor,
             msg_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
             d_out: int) -> torch.Tensor:
        """agg[dst] = Σ_edges msg_fn(payload[src], payload[dst]).

        msg_fn: (src_rows (M, Dp), dst_rows (M, Dp)) -> (M, d_out), each row
        from its own edge alone, called on blocks of ``block`` edges in
        destination order. Every chunk's messages go through the segment-sum
        kernel into their output rows; the chunks tile ``[0, N)``, so every
        row is written.
        """
        token, buffer = self._sink(node_payload)
        return self._aggregate(self.messages(msg_fn, token, buffer),
                               node_payload, d_out)

    def _aggregate(self, chunk_msgs, node_payload: torch.Tensor,
                   d_out: int) -> torch.Tensor:
        """Segment-sums each chunk's messages (Ec, d_out) into rows
        ``[seg_lo, seg_hi)``: written in place (no grad), or each chunk's
        own rows joined in chunk order (messages that need a gradient)."""
        agg, parts = None, []
        for (lo, _, _, _, rp), msgs in chunk_msgs:
            if msgs.requires_grad:
                parts.append(ops.segment_sum_csr(msgs.contiguous(), rp))
                continue
            if agg is None:
                agg = node_payload.new_empty((self.n, d_out))
            ops.segment_sum_csr(msgs.contiguous(), rp, out=agg, seg_lo=lo)
        if parts:
            return torch.cat(parts)
        return node_payload.new_empty((self.n, d_out)) if agg is None else agg



class LocalExec(SortedEdges):
    """Single-device engine over a FlatGraph: its edges sorted by
    destination over its own nodes (``SortedEdges``)."""

    def __init__(self, g: FlatGraph, chunk_edges: Optional[int] = None):
        self.g = g
        super().__init__(g.edge_src, g.edge_dst, g.edge_mask, g.n_nodes,
                         chunk_edges)

    def edge_geometry(self):
        """(rel (E, 3), dist (E,)) in the graph's edge order; masked edges
        have distance 0."""
        pos = self.g.positions
        rel = pos[self.g.edge_src] - pos[self.g.edge_dst]
        dist = torch.linalg.vector_norm(rel, dim=-1)
        return rel, torch.where(self.g.edge_mask, dist, 0.0)

    def gather_src(self, node_payload: torch.Tensor) -> torch.Tensor:
        """Per-edge source rows (E, Dp) in the graph's edge order, 0 on
        masked edges."""
        srcs = node_payload[self.g.edge_src]
        return torch.where(self.g.edge_mask[:, None], srcs, 0.0)

    def dst_index(self):
        """Flat destination index + mask (edge order matches gather_src)."""
        return self.g.edge_dst, self.g.edge_mask

    def push_attn(self, node_payload: torch.Tensor, logit_fn, msg_fn,
                  d_out: int) -> torch.Tensor:
        """Softmax-normalised (per destination) attention aggregation:
        logit_fn gives (M, H), msg_fn (M, H, dh) with H · dh = d_out. A
        chunk holds every in-edge of its destinations, so each softmax is
        chunk-local. Both message streams read the payload through one
        sink, so the call keeps one gradient buffer."""
        token, buffer = self._sink(node_payload)

        def weighted():
            for (chunk, logits), (_, msgs) in zip(
                    self.messages(logit_fn, token, buffer),
                    self.messages(msg_fn, token, buffer)):
                lo, hi, e0, e1, _ = chunk
                w = seg.segment_softmax(logits, self.dst[e0:e1] - lo, hi - lo)
                yield chunk, (msgs * w[..., None]).reshape(e1 - e0, d_out)

        return self._aggregate(weighted(), node_payload, d_out)


class RingGraph(NamedTuple):
    """Distributed flat layout (global tensors; leading dims shard over the
    data axes). Node arrays: (N, ...) block-sharded (owner = id // n_loc).
    Edge arrays: (S, R, E_cap): shard s's edges grouped by source-owner
    round r (source owner (s - r) mod S), with local indices."""
    feats: torch.Tensor        # (N, F)
    positions: torch.Tensor    # (N, 3)
    esrc_local: torch.Tensor   # (S, R, E_cap) int32 — row in the rotating buffer
    edst_local: torch.Tensor   # (S, R, E_cap) int32 — local destination row
    edge_mask: torch.Tensor    # (S, R, E_cap) bool
    node_mask: torch.Tensor    # (N,) bool
    labels: torch.Tensor       # (N,) int32


def pad_to_shards(g: FlatGraph, n_shards: int) -> FlatGraph:
    """``g`` with masked nodes appended (zero features and positions,
    label 0, no edges) up to a multiple of ``n_shards``: ``to_ring`` needs
    N to divide by the shards."""
    pad = (-g.n_nodes) % n_shards
    if not pad:
        return g

    def grow(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    return g._replace(feats=grow(g.feats), positions=grow(g.positions),
                      node_mask=grow(g.node_mask), labels=grow(g.labels))


def to_ring(g: FlatGraph, n_shards: int, e_cap: Optional[int] = None
            ) -> RingGraph:
    """Regroups a FlatGraph into the ring layout, on ``g``'s device: the
    reference's arrays bit for bit (each (shard, round) takes its valid
    edges in edge order, the first ``e_cap`` of them; ``e_cap`` None = the
    largest group), from one stable sort of the edges by (shard, round)
    instead of its host loop over them."""
    n = g.n_nodes
    assert n % n_shards == 0, (n, n_shards)
    n_loc, groups = n // n_shards, n_shards * n_shards
    src = g.edge_src[g.edge_mask].to(torch.int64)
    dst = g.edge_dst[g.edge_mask].to(torch.int64)
    d_own = dst // n_loc
    key = d_own * n_shards + (d_own - src // n_loc) % n_shards
    counts = torch.bincount(key, minlength=groups)
    if e_cap is None:
        e_cap = max(1, int(counts.max()))
    key, order = torch.sort(key, stable=True)
    pos = (torch.arange(key.numel(), device=key.device)
           - (torch.cumsum(counts, 0) - counts)[key])
    keep = pos < e_cap
    slot, idx = key[keep] * e_cap + pos[keep], order[keep]
    arrays = []
    for vals in (src % n_loc, dst % n_loc, None):
        a = torch.zeros(groups * e_cap, device=key.device,
                        dtype=torch.bool if vals is None else torch.int32)
        a[slot] = True if vals is None else vals[idx].to(torch.int32)
        arrays.append(a.reshape(n_shards, n_shards, e_cap))
    return RingGraph(g.feats, g.positions, *arrays, g.node_mask, g.labels)


def _ring_axes(mesh: Mesh) -> tuple:
    """The data axes a ring shards nodes over (at least one)."""
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"RingExec: the mesh {mesh.shape} has no 'pod' or "
                         "'data' axis to shard nodes over")
    return axes


class RingShard:
    """The ring engine of one shard: the reference's ``RingExec`` inside
    ``shard_map``, run by ``collectives.spmd`` (one thread a shard).

    It holds the shard's own (R, cap) edge slots (its "model" piece of
    each round on a grid), ``n_loc`` and its ``ShardCtx``. ``push``,
    ``push_attn``, ``gather_src`` and ``dst_index`` take and return the
    shard's own (n_loc, ·) blocks and local rows. Over R rounds the shard
    aggregates round r's edges from the block that has rotated to it (the
    source owner's: ``ctx.rotate`` between rounds) into its own
    destinations, through a ``SortedEdges`` of that round (``engines``):
    ``LocalExec``'s sort, blocks, chunks and kernels, so a round's peak
    memory is ``LocalExec``'s and its bits do not depend on the chunk
    budget. With a "model" axis (``split_model``) the rounds' sums are
    ``psum``med over "model"; the rounds add in round order.

    Under grad the shard reads its own block through a ``_GradSink``, so
    every gather's transpose adds in place into a buffer. A block that
    rotates in from a shard of the same device is the sender's token
    itself (``rotate`` moves nothing), and its transposes add into the
    buffer that token carries: the rotation takes no gradient, and a
    device holds one buffer a shard, as one program over its shards
    would. Autograd runs one device's backward in one thread, in the
    order ``spmd``'s turns numbered it, so the sums keep their bits. A
    block that crossed devices is a copy, read through a sink of its own
    on the shard's device, whose gradient goes back through the
    rotation."""

    def __init__(self, esrc: torch.Tensor, edst: torch.Tensor,
                 emask: torch.Tensor, n_loc: int, ctx: col.ShardCtx, *,
                 split_model: bool = True,
                 chunk_edges: Optional[int] = None,
                 engines: Optional[List[SortedEdges]] = None):
        self.ctx, self.axes = ctx, _ring_axes(ctx.mesh)
        n_shards = col.size(ctx.mesh, self.axes)
        if esrc.dim() != 2 or esrc.shape[0] != n_shards:
            raise ValueError(f"a shard's ring takes its (R, cap) slots with "
                             f"R = {n_shards}, got {tuple(esrc.shape)}")
        split = split_model and ctx.mesh.shape.get("model", 1) > 1
        self.model_axis = "model" if split else None
        self.n, self.rounds = n_loc, esrc.shape[0]
        self.esrc, self.edst, self.emask = esrc, edst, emask
        self.engines = engines if engines is not None else [
            SortedEdges(esrc[r], edst[r], emask[r], n_loc, chunk_edges)
            for r in range(self.rounds)]

    def sized(self, edge_bytes: int, row_bytes: int) -> "RingShard":
        """This engine with every round's ``SortedEdges.sized``."""
        ex = copy.copy(self)
        ex.engines = [e.sized(edge_bytes, row_bytes) for e in self.engines]
        return ex

    def _rounds(self, token, buffer, fn) -> list:
        """``fn(r, engine, src token, src buffer)`` for every round: round
        0 reads the shard's own block (``token``, ``buffer``), round r the
        block rotated in r steps: a token with its buffer where it stayed
        on this device, else read through a sink of its own."""
        held, held_buf, out = token, buffer, []
        for r, eng in enumerate(self.engines):
            if r:
                held = self.ctx.rotate(held, self.axes)
                held_buf = getattr(held, "grad_buffer", None)
                if held_buf is None:
                    held, held_buf = SortedEdges._sink(held)
            out.append(fn(r, eng, held, held_buf))
        return out

    def _reduce(self, parts) -> torch.Tensor:
        """Adds the round sums in round order and ``psum``s over
        "model"."""
        acc = None
        for part in parts:
            if acc is None:
                acc = part
            elif acc.requires_grad or part.requires_grad:
                acc = acc + part
            else:
                acc.add_(part)
        if self.model_axis:
            acc = self.ctx.psum(acc, self.model_axis)
        return acc

    def push(self, node_payload: torch.Tensor, msg_fn, d_out: int
             ) -> torch.Tensor:
        """agg[dst] = Σ_edges msg_fn(payload[src], payload[dst]) over the
        ring: this shard's (n_loc, Dp) block -> (n_loc, d_out)."""
        token, buffer = SortedEdges._sink(node_payload)

        def one(r, eng, held, held_buf):
            return eng._aggregate(eng.messages(msg_fn, token, buffer, held,
                                               held_buf), token, d_out)

        return self._reduce(self._rounds(token, buffer, one))

    def push_attn(self, node_payload: torch.Tensor, logit_fn, msg_fn,
                  d_out: int) -> torch.Tensor:
        """Softmax-normalised (per destination) attention aggregation over
        the ring, as the reference's: pass 1 takes every round's logits,
        the softmax runs over each destination's edges of all rounds (its
        shift the max over the shard and "model", without gradient; its
        denominator ``psum``med over "model"), pass 2 weights the rounds'
        messages, which are summed as in ``push``."""
        token, buffer = SortedEdges._sink(node_payload)
        n, engines = self.n, self.engines

        def rows(r, eng, held, held_buf):
            parts = [x for _, x in eng.messages(logit_fn, token, buffer, held,
                                                held_buf)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        logits = torch.cat(self._rounds(token, buffer, rows))
        dst = torch.cat([e.dst.to(torch.int64) for e in engines])
        m = seg.segment_max(logits.detach(), dst, n)
        m = torch.where(torch.isfinite(m), m, -3e38)
        if self.model_axis:
            m = self.ctx.all_gather(m, self.model_axis, tiled=False).amax(0)
        sh = logits - m.index_select(0, dst)
        e = torch.where(torch.isfinite(sh), torch.exp(sh), 0.0)
        z = seg.segment_sum(e, dst, n)
        if self.model_axis:
            z = self.ctx.psum(z, self.model_axis)
        w = e / torch.clamp(seg.gather_rows(z, dst), min=1e-20)
        w = torch.split(w, [e_.n_edges for e_ in engines])

        def weighted(r, eng, held, held_buf):
            def chunks():
                for chunk, msgs in eng.messages(msg_fn, token, buffer, held,
                                                held_buf):
                    e0, e1 = chunk[2], chunk[3]
                    yield chunk, (msgs * w[r][e0:e1, :, None]).reshape(
                        e1 - e0, d_out)

            return eng._aggregate(chunks(), token, d_out)

        return self._reduce(self._rounds(token, buffer, weighted))

    def gather_src(self, node_payload: torch.Tensor) -> torch.Tensor:
        """Per-edge source rows (R·cap, Dp) in slot order (round, slot), 0
        on masked slots: each round takes from the block that has rotated
        to the shard. Under grad the gathers' transposes add in place
        (``sparse.segment.gather_rows``)."""
        held, rows = node_payload, []
        for r in range(self.rounds):
            if r:
                held = self.ctx.rotate(held, self.axes)
            idx = self.esrc[r].to(torch.int64)
            rows.append(torch.where(self.emask[r][:, None],
                                    seg.gather_rows(held, idx), 0.0))
        return torch.cat(rows)

    def dst_index(self):
        """Local destination row (R·cap,) and mask, in ``gather_src``'s
        slot order (the reference's)."""
        return self.edst.reshape(-1).to(torch.int64), self.emask.reshape(-1)


class RingExec:
    """The ring over a whole mesh: what callers build once (``of``, or
    the constructor given the (S, R, cap) arrays of ``RingGraph`` or of
    DimeNet's triplet ring, on the mesh's first device) and pass as
    ``ex``. ``shard(ctx)`` gives each shard's ``RingShard`` inside
    ``spmd``: shard (d, m) takes data row d of the arrays and, split over
    "model", slot piece m of each round, moved to its device once; its
    ``SortedEdges`` are built at first use and kept across calls.
    ``engines`` (each shard's, in shard order), ``chunk_count`` and
    ``block_count`` cover every shard."""

    def __init__(self, esrc: torch.Tensor, edst: torch.Tensor,
                 emask: torch.Tensor, n_loc: int, mesh: Mesh, *,
                 split_model: bool = True,
                 chunk_edges: Optional[int] = None):
        self.mesh = require_mesh(mesh, "RingExec")
        self.axes = _ring_axes(mesh)
        n_shards = col.size(mesh, self.axes)
        s, r, _ = esrc.shape
        if s != n_shards:
            raise ValueError(f"RingGraph built for {s} shards but mesh has "
                             f"{n_shards} data shards")
        first = col.shards(mesh)[0].device
        if esrc.device != first:
            raise ValueError(f"RingExec: the ring's arrays are on "
                             f"{esrc.device}, the mesh's first shard on "
                             f"{first}")
        split = split_model and mesh.shape.get("model", 1) > 1
        self.model_axis = "model" if split else None
        self.n, self.rounds, self.chunk_edges = n_loc, r, chunk_edges
        self.esrc, self.edst, self.emask = esrc, edst, emask
        # each shard's (slots on its device, its engines by round or None)
        self._shards: list = [None] * len(col.shards(mesh))

    def shard(self, ctx: col.ShardCtx) -> RingShard:
        """This ring's engine for ``ctx``'s shard (inside ``spmd``)."""
        kept = self._shards[ctx.index]
        if kept is None:
            d = ctx.axis_index(self.axes)
            slots = [a[d] for a in (self.esrc, self.edst, self.emask)]
            if self.model_axis:
                piece = -(-slots[0].shape[1] // self.mesh.shape["model"])
                m = ctx.shard.coords["model"]
                slots = [a[:, m * piece:(m + 1) * piece] for a in slots]
            kept = [[a.to(ctx.device) for a in slots], None]
            self._shards[ctx.index] = kept
        ex = RingShard(*kept[0], self.n, ctx,
                       split_model=self.model_axis is not None,
                       chunk_edges=self.chunk_edges, engines=kept[1])
        kept[1] = ex.engines
        return ex

    @property
    def engines(self) -> List[List[SortedEdges]]:
        """Every shard's ``SortedEdges`` by round, in shard order, built
        (in ``spmd``, each shard on its device) where missing."""
        if any(k is None or k[1] is None for k in self._shards):
            col.spmd(self.mesh, self.shard)
        return [k[1] for k in self._shards]

    def chunk_count(self) -> int:
        """Segment-sum launches of one ``push`` over the mesh: the chunks
        of every shard's rounds."""
        return sum(len(e.chunks) for es in self.engines for e in es)

    def block_count(self) -> int:
        """Message blocks of one ``push`` over the mesh. Under grad the
        in-place kernel launches twice a block (its gathers'
        transposes)."""
        return sum(-(-e.n_edges // e.block) for es in self.engines
                   for e in es)

    @classmethod
    def of(cls, g: RingGraph, mesh: Mesh,
           chunk_edges: Optional[int] = None) -> "RingExec":
        """The ring over a ``RingGraph``'s edges, its nodes split evenly
        over the mesh's data shards."""
        n_shards = g.esrc_local.shape[0]
        if g.feats.shape[0] % n_shards:
            raise ValueError(f"{g.feats.shape[0]} nodes do not divide into "
                             f"{n_shards} shards")
        return cls(g.esrc_local, g.edst_local, g.edge_mask,
                   g.feats.shape[0] // n_shards, mesh,
                   chunk_edges=chunk_edges)


def run_shards(mesh: Mesh, params, nodes, body) -> dict:
    """The reference's ``shard_map`` of a ring body: ``nodes`` (the graph's
    (N, ...) node arrays) split into each data shard's block on its device
    (``nspec``), ``params`` replicated (``P()``), ``body(ctx, params,
    *blocks)`` run once per shard (``collectives.spmd``); its loss-like
    sums are ``psum``med over the data axes in shard order, and the first
    shard's come back (``out_specs=P()``), on its device."""
    axes = data_axes(mesh)
    blocks = [col.split(t, mesh, axes) for t in nodes]

    def one(ctx, p, *bs):
        out = body(ctx, p, *bs)
        return tree_map(lambda t: ctx.psum(t, axes), out)

    return col.spmd(mesh, one, col.replicate_tree(params, mesh), *blocks)[0]


def run_flat(apply_local, g, params, mesh=None, *, ex=None):
    """Dispatch: ``apply_local(params, feats, positions, node_mask, labels,
    ex)`` on a ``LocalExec`` over the FlatGraph ``g`` (no mesh), or once per
    data shard over the RingGraph ``g`` and ``mesh``: on that shard's
    (n_loc, ...) node blocks, on its device, with its ``RingShard``
    (``RingExec.shard``, ``run_shards``). ``ex``: an engine built on ``g`` once and reused.
    apply_local returns loss-like sums; over a mesh they are the sums over
    every shard's nodes, the reference's closing ``psum`` over the data
    axes."""
    if mesh is None:
        ex = LocalExec(g) if ex is None else ex
        return apply_local(params, g.feats, g.positions, g.node_mask,
                           g.labels, ex)
    require_mesh(mesh, "run_flat")
    if not isinstance(g, RingGraph):
        raise TypeError("run_flat over a mesh takes a RingGraph "
                        "(models.gnn.common.to_ring)")
    ex = RingExec.of(g, mesh) if ex is None else ex
    return run_shards(
        mesh, params, (g.feats, g.positions, g.node_mask, g.labels),
        lambda ctx, p, *nodes: apply_local(p, *nodes, ex.shard(ctx)))
