"""Synthetic multimodal corpora + knowledge graphs (the GraphGen analogue the
paper uses for its billion-scale KG benchmarks, scaled to this container).

Embeddings are drawn from planted Gaussian clusters so ANN recall has ground
truth structure; the KG is drawn with intra-cluster preferential attachment so
graph neighborhoods correlate with embedding neighborhoods (the regime where
hybrid fusion helps — and what makes the §5.3 ablation meaningful).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MultimodalCorpus:
    node_ids: Dict[str, np.ndarray]          # modality -> (N_m,) global ids
    vectors: Dict[str, np.ndarray]           # modality -> (N_m, d_m) fp32
    src: np.ndarray                          # KG edges
    dst: np.ndarray
    edge_type: np.ndarray
    cluster_of: np.ndarray                   # (N,) planted cluster per node
    n_nodes: int


def make_corpus(
    n_nodes: int = 2000,
    modality_dims: Optional[Dict[str, int]] = None,
    n_clusters: int = 16,
    intra_p: float = 0.015,
    inter_p: float = 0.0005,
    n_edge_types: int = 4,
    noise: float = 0.25,
    seed: int = 0,
) -> MultimodalCorpus:
    rng = np.random.default_rng(seed)
    modality_dims = modality_dims or {"text": 64, "image": 96}
    mods = list(modality_dims)
    cluster = rng.integers(0, n_clusters, n_nodes)
    modality = rng.integers(0, len(mods), n_nodes)

    node_ids, vectors = {}, {}
    for mi, mod in enumerate(mods):
        d = modality_dims[mod]
        centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        mask = modality == mi
        ids = np.where(mask)[0].astype(np.int32)
        v = centers[cluster[mask]] + noise * rng.normal(size=(mask.sum(), d)).astype(np.float32)
        node_ids[mod] = ids
        vectors[mod] = v.astype(np.float32)

    # planted-partition KG (preferential within clusters)
    n_intra = int(intra_p * n_nodes * n_nodes / n_clusters)
    n_inter = int(inter_p * n_nodes * n_nodes)
    srcs, dsts = [], []
    for c in range(n_clusters):
        members = np.where(cluster == c)[0]
        if len(members) < 2:
            continue
        e = rng.integers(0, len(members), (max(n_intra // n_clusters, len(members)), 2))
        srcs.append(members[e[:, 0]])
        dsts.append(members[e[:, 1]])
    e = rng.integers(0, n_nodes, (max(n_inter, 1), 2))
    srcs.append(e[:, 0])
    dsts.append(e[:, 1])
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    et = rng.integers(0, n_edge_types, len(src)).astype(np.int32)
    return MultimodalCorpus(node_ids, vectors, src, dst, et, cluster, n_nodes)


def ground_truth_topk(vectors: np.ndarray, ids: np.ndarray, queries: np.ndarray,
                      k: int) -> np.ndarray:
    """Exact cosine top-k ids (recall oracle)."""
    v = vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
    q = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    s = q @ v.T
    top = np.argsort(-s, axis=1)[:, :k]
    return ids[top]


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean |pred ∩ true| / k."""
    hits = 0
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(int(x) for x in p if x >= 0) & set(int(x) for x in t))
    return hits / (len(true_ids) * true_ids.shape[1])


def make_lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
