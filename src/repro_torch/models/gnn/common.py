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

The ring engine (``RingGraph``, ``RingExec``, ``to_ring``) and ``run_flat``
over a mesh wait for sharding (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import copy
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.segment_reduce import ops
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
        ops.segment_sum_csr_accumulate(grad.contiguous(), rowptr, perm,
                                       out=self.buf, rows=rows, seg_lo=seg_lo)

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


class LocalExec:
    """Single-device engine over a FlatGraph, with destination-sorted edges
    (see the module docstring). ``chunks`` lists ``(seg_lo, seg_hi, e0, e1,
    rowptr)`` with ``rowptr`` rebased to the chunk's first edge; ``block``
    is the row count of every ``msg_fn`` call: the valid edges rounded up
    to a power of two, at most ``MSG_BLOCK_EDGES`` (or ``sized``'s)."""

    def __init__(self, g: FlatGraph, chunk_edges: int = DEFAULT_CHUNK_EDGES):
        if chunk_edges < 1:
            raise ValueError(f"chunk_edges must be >= 1, got {chunk_edges}")
        self.g = g
        self.n = g.n_nodes
        self.chunk_edges = chunk_edges
        src, dst = g.edge_src, g.edge_dst
        ok = g.edge_mask & (dst >= 0) & (dst < self.n)
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

    def sized(self, edge_bytes: int, row_bytes: int) -> "LocalExec":
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

    def edge_geometry(self):
        """(rel (E, 3), dist (E,)) in the graph's edge order; masked edges
        have distance 0."""
        pos = self.g.positions
        rel = pos[self.g.edge_src] - pos[self.g.edge_dst]
        dist = torch.linalg.vector_norm(rel, dim=-1)
        return rel, torch.where(self.g.edge_mask, dist, 0.0)

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
                    buffer=None):
        """``fn(src rows, dst rows)`` of sorted-edge block k, padded to
        ``block`` rows with copies of node 0. Under grad the block is
        checkpointed; with a ``buffer`` (``node_payload`` is then its
        sink's token) its gathers are ``_GatherRows``."""
        a = k * self.block
        src = self.src[a:a + self.block]
        dst = self.dst[a:a + self.block]
        if src.numel() < self.block:
            pad = src.new_zeros(self.block - src.numel())
            src, dst = torch.cat([src, pad]), torch.cat([dst, pad])
        if not torch.is_grad_enabled():
            return fn(node_payload.index_select(0, src),
                      node_payload.index_select(0, dst))

        def run(payload):
            if buffer is None:
                return fn(payload.index_select(0, src),
                          payload.index_select(0, dst))
            return fn(_GatherRows.apply(
                          payload, src, lambda g: self._add_src(buffer, k, g)),
                      _GatherRows.apply(
                          payload, dst, lambda g: self._add_dst(buffer, k, g)))

        return checkpoint(run, node_payload, use_reentrant=False)

    @staticmethod
    def _sink(node_payload: torch.Tensor):
        """(what the blocks read, the gradient buffer or None): under grad,
        a payload that takes a gradient is read through a ``_GradSink``."""
        if not (torch.is_grad_enabled() and node_payload.requires_grad):
            return node_payload, None
        buffer = _GradBuffer(node_payload)
        return _GradSink.apply(node_payload, buffer), buffer

    def messages(self, fn, node_payload: torch.Tensor, buffer=None):
        """Yields ``(chunk, rows)`` for every chunk in order: ``rows`` is
        ``fn(src rows, dst rows)`` of the chunk's edges (Ec, ...), taken
        from the fixed blocks of sorted edges (the module docstring says
        why). fn must compute each row from its own edge alone. With a
        ``buffer``, ``node_payload`` is its sink's token (``_sink``)."""
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
                    last_k, last = k, self._block_rows(fn, node_payload, k,
                                                       buffer)
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


def run_flat(apply_local, g: FlatGraph, params, mesh=None):
    """Single-device dispatch: ``apply_local(params, feats, positions,
    node_mask, labels, LocalExec(g))``. A mesh (the reference's shard_map
    ring) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "run_flat over a mesh (RingGraph / RingExec) is not ported to "
            "repro_torch yet (ROADMAP.md Queue 1 item 15)")
    ex = LocalExec(g)
    return apply_local(params, g.feats, g.positions, g.node_mask, g.labels, ex)
