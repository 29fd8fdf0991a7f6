"""Layer-wise neighbour sampler (GraphSAGE-style fanout trees), the port of
``repro.sparse.sampler``: CSR-backed, host numpy, per-target padded trees so
the device step is fixed-shape.

The draws are the reference's: one ``rng.integers(lo, hi, k)`` per visited
node, tree by tree, layer by layer, parent by parent, so the same seed gives
equal arrays. Only the filling of a parent's ``k`` children is a slice
assignment instead of the reference's per-child loop.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SampledBatch:
    """Per-target padded subgraph trees, stacked over the batch.

    nodes:    (B, n_sub) int32  global node ids (row 0 = the target), -1 pad
    feats:    (B, n_sub, F) fp32
    edge_src: (B, n_edge) int32  local (within-sample) indices
    edge_dst: (B, n_edge) int32
    edge_mask:(B, n_edge) bool
    labels:   (B,) int32
    """
    nodes: np.ndarray
    feats: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    labels: np.ndarray


def sizes_for_fanout(fanouts: Tuple[int, ...]) -> Tuple[int, int]:
    """(n_sub, n_edge) for a padded fanout tree."""
    n_sub, frontier, n_edge = 1, 1, 0
    for f in fanouts:
        n_edge += frontier * f
        frontier *= f
        n_sub += frontier
    return n_sub, n_edge


class NeighborSampler:
    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray,
                 feats: np.ndarray, labels: np.ndarray, seed: int = 0):
        order = np.argsort(dst, kind="stable")       # CSR by dst: in-neighbours
        self.nbr = src[order].astype(np.int32)
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.feats = feats
        self.labels = labels
        self.rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes

    def _sample_neighbors(self, node: int, k: int) -> np.ndarray:
        lo, hi = self.indptr[node], self.indptr[node + 1]
        if hi == lo:
            return np.full(k, -1, np.int32)
        idx = self.rng.integers(lo, hi, k)
        return self.nbr[idx]

    def sample(self, targets: np.ndarray, fanouts: Tuple[int, ...]
               ) -> SampledBatch:
        b = len(targets)
        n_sub, n_edge = sizes_for_fanout(fanouts)
        nodes = np.full((b, n_sub), -1, np.int32)
        esrc = np.zeros((b, n_edge), np.int32)
        edst = np.zeros((b, n_edge), np.int32)
        emask = np.zeros((b, n_edge), bool)
        for i, t in enumerate(targets):
            nodes[i, 0] = t
            frontier = [0]                      # local indices of current layer
            nxt = 1
            e = 0
            for f in fanouts:
                new_frontier = []
                for loc in frontier:
                    g = nodes[i, loc]
                    nb = (self._sample_neighbors(int(g), f) if g >= 0
                          else np.full(f, -1, np.int32))
                    # children nxt .. nxt+f-1; messages flow child -> parent
                    nodes[i, nxt:nxt + f] = nb
                    esrc[i, e:e + f] = np.arange(nxt, nxt + f)
                    edst[i, e:e + f] = loc
                    emask[i, e:e + f] = nb >= 0
                    new_frontier.extend(range(nxt, nxt + f))
                    nxt += f
                    e += f
                frontier = new_frontier
            assert e == n_edge and nxt == n_sub
        safe = np.clip(nodes, 0, self.n_nodes - 1)
        feats = self.feats[safe] * (nodes >= 0)[..., None]
        labels = self.labels[targets]
        return SampledBatch(nodes, feats.astype(np.float32), esrc, edst, emask,
                            labels.astype(np.int32))
