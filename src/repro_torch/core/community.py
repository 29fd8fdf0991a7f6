"""Community detection for multi-hop reasoning (paper §3.4: "community-based
multi-hop reasoning using Louvain").

Index-build-time (host-side, numpy): one-level Louvain — greedy modularity
moves until convergence, the reference's code with its seeded shuffle, so
the labels are identical. Communities bias traversal (same-community hops
get a weight boost). ``label_propagation`` is the reference's device
fallback for graphs too large for the host sweep; nothing calls it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_store import GraphStore


def louvain_one_level(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                      weight: np.ndarray, max_sweeps: int = 10,
                      seed: int = 0) -> np.ndarray:
    """Greedy modularity optimisation, one level (no coarsening).

    Returns (N,) community labels. Edges should be directed pairs; the graph
    is treated as undirected (weights summed both ways).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weight, np.float64)
    # symmetrise
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = np.concatenate([w, w])
    m2 = w2.sum()  # = 2m
    if m2 <= 0:
        return np.zeros(n_nodes, np.int32)

    # CSR for neighbor iteration
    order = np.argsort(s2, kind="stable")
    s2, d2, w2 = s2[order], d2[order], w2[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(s2, minlength=n_nodes), out=indptr[1:])

    k = np.zeros(n_nodes, np.float64)       # weighted degree
    np.add.at(k, s2, w2)
    labels = np.arange(n_nodes, dtype=np.int64)
    sigma_tot = k.copy()                    # community total degree

    rng = np.random.default_rng(seed)
    nodes = np.arange(n_nodes)
    for _ in range(max_sweeps):
        moved = 0
        rng.shuffle(nodes)
        for u in nodes:
            lo, hi = indptr[u], indptr[u + 1]
            if lo == hi:
                continue
            nbr, nw = d2[lo:hi], w2[lo:hi]
            cu = labels[u]
            # weights from u to each neighboring community
            comms, inv = np.unique(labels[nbr], return_inverse=True)
            w_to = np.zeros(len(comms))
            np.add.at(w_to, inv, nw)
            # remove u from its community
            sigma_tot[cu] -= k[u]
            w_cu = w_to[comms == cu].sum() if (comms == cu).any() else 0.0
            # modularity gain of joining community c: w_uc - k_u * sigma_c / m2
            gains = w_to - k[u] * sigma_tot[comms] / m2
            base = w_cu - k[u] * sigma_tot[cu] / m2
            best = int(np.argmax(gains))
            if gains[best] > base + 1e-12 and comms[best] != cu:
                labels[u] = comms[best]
                moved += 1
            sigma_tot[labels[u]] += k[u]
        if moved == 0:
            break
    # relabel densely
    _, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int32)


def modularity(n_nodes: int, src, dst, weight, labels) -> float:
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weight, np.float64)
    labels = np.asarray(labels)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = np.concatenate([w, w])
    m2 = w2.sum()
    if m2 <= 0:
        return 0.0
    k = np.zeros(n_nodes)
    np.add.at(k, s2, w2)
    intra = w2[labels[s2] == labels[d2]].sum() / m2
    sig = np.zeros(labels.max() + 1)
    np.add.at(sig, labels, k)
    return float(intra - np.sum((sig / m2) ** 2))


def label_propagation(g: GraphStore, n_iters: int = 10) -> torch.Tensor:
    """Min-label propagation on the graph's device (connected-component
    flavoured): O(E) per iteration. Each node takes the least label among
    itself and the sources of its in-edges, ``n_iters`` times. Returns (N,)
    int32 labels, equal to the reference's."""
    n = g.n_nodes
    src, dst = g.src.long(), g.indices.long()
    labels = torch.arange(n, dtype=torch.int32, device=g.src.device)
    for _ in range(n_iters):
        labels = labels.scatter_reduce(0, dst, labels[src], reduce="amin",
                                       include_self=True)
    return labels


def community_edge_boost(g: GraphStore, labels, boost: float = 1.5) -> torch.Tensor:
    """Edge weights boosted within communities (traversal bias, §3.4)."""
    lab = torch.as_tensor(np.asarray(labels), device=g.src.device).long()
    same = lab[g.src.long()] == lab[g.indices.long()]
    return g.edge_weight * torch.where(same, boost, 1.0)
