"""Quickstart on the PyTorch port: build an HMGI index over a synthetic
multimodal corpus, run vector, hybrid, NSW-refined and reranked queries,
an anytime progressive search, a live update, compact.

    PYTHONPATH=src python examples/torch_quickstart.py                 # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.core.progressive import progressive_search
from repro_torch.core.rerank import SparseVectors, hash_terms
from repro_torch.data.synthetic import (ground_truth_topk, make_corpus,
                                        recall_at_k)


def main(device):
    # 1. corpus: two modalities + a knowledge graph
    corpus = make_corpus(n_nodes=2000, modality_dims={"text": 64, "image": 96},
                         seed=0)
    print(f"corpus: {corpus.n_nodes} nodes, {len(corpus.src)} edges, "
          f"modalities={list(corpus.vectors)}")

    # 2. build the index (modality-aware partitions, int8 quantization)
    #    and each modality's NSW graph for the refine lane
    cfg = get_config("hmgi").replace(n_partitions=32, n_probe=8, quant_bits=8)
    index = HMGIIndex(cfg, seed=0, device=device)
    index.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
                  for m in corpus.vectors}, n_nodes=corpus.n_nodes,
                 edges=(corpus.src, corpus.dst, corpus.edge_type),
                 build_nsw=True)
    print(f"index on {index.device}: "
          f"{index.memory_usage()['total']/2**20:.2f} MiB")

    # 3. vector search, and the same with the NSW refine lane merged in
    rng = np.random.default_rng(1)
    sel = rng.integers(0, len(corpus.vectors["text"]), 16)
    queries = corpus.vectors["text"][sel] + 0.05 * rng.normal(
        size=(16, 64)).astype(np.float32)
    truth = ground_truth_topk(corpus.vectors["text"], corpus.node_ids["text"],
                              queries, 10)
    _, ids = index.search(queries, "text", k=10, n_probe=2)
    print(f"vector recall@10 at n_probe 2: "
          f"{recall_at_k(ids.cpu().numpy(), truth):.3f}")
    index.cfg = cfg.replace(use_nsw_refine=True)
    _, ids = index.search(queries, "text", k=10, n_probe=2)
    print(f"  with the NSW refine lane: "
          f"{recall_at_k(ids.cpu().numpy(), truth):.3f}")
    index.cfg = cfg

    # 4. hybrid search (Eq. 3 fusion: ANN seeds -> 2-hop traversal -> fused
    #    rank), traced stage by stage
    _, hids, trace = index.hybrid_search(queries, "text", k=10, n_hops=2,
                                         trace=True)
    print(f"hybrid top-1 ids: {hids[:4, 0].tolist()}")
    print(trace.render())

    # 5. sparse-dense rerank: hashed-term documents, reciprocal-rank fusion
    tokens = torch.as_tensor(rng.integers(0, 5000, (corpus.n_nodes, 16)))
    index.set_sparse_docs(SparseVectors(
        hash_terms(tokens, 1 << 12), torch.rand(corpus.n_nodes, 16)))
    q_terms = hash_terms(tokens[int(hids[0, 0])], 1 << 12)
    _, rids = index.hybrid_search(queries, "text", k=10, n_hops=2,
                                  use_rerank=True, q_terms=q_terms,
                                  q_term_weights=torch.ones(16))
    print(f"reranked top-1 ids: {rids[:4, 0].tolist()}")

    # 6. anytime search: each round probes more partitions
    m = index.modalities["text"]
    for r in progressive_search(m.ivf, index._norm_queries(queries), k=10):
        print(f"  round {r.round}: n_probe {r.n_probe:2d}, recall@10 "
              f"{recall_at_k(r.ids.cpu().numpy(), truth):.3f}, "
              f"{r.elapsed_s * 1e3:.2f} ms of work")

    # 7. dynamic update: insert a new vector, find it, delete it. Writes
    #    land in the MVCC delta; adaptive maintenance drains it in bounded
    #    steps — compact() is the synchronous full merge (and rebuilds the
    #    NSW graph over the latest rows)
    new_vec = np.zeros((1, 64), np.float32)
    new_vec[0, 0] = 1.0
    index.insert("text", np.array([1999]), new_vec)
    _, found = index.search(new_vec, "text", k=1)
    print(f"inserted id found: {int(found[0, 0]) == 1999}")
    index.delete("text", np.array([1999]))
    report = index.maintain("text", budget=256)   # bounded adaptive pass
    print(f"maintenance: {report.describe()}")
    index.compact("text")
    print("compacted; delta flushed into the stable index")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
