"""End-to-end serving on the PyTorch port (the paper's target
application): HMGI retrieval + continuous-batched RAG generation with a
small phi4-family LM, plus the declarative query API (``Q``) for
relationship-heavy retrieval.

    PYTHONPATH=src python examples/torch_multimodal_rag.py             # CUDA
    PYTHONPATH=src python examples/torch_multimodal_rag.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import HMGIIndex
from repro_torch.data.synthetic import make_corpus
from repro_torch.models import lm
from repro_torch.query import Q
from repro_torch.serving.engine import EngineConfig, RAGEngine


def main(device):
    # 1. knowledge corpus + index: text and image entities in one graph,
    #    typed edges (we treat type 1 as :authored), a `year` attribute
    corpus = make_corpus(n_nodes=1500, modality_dims={"text": 48, "image": 32},
                         seed=0)
    authored = 1
    rng0 = np.random.default_rng(0)
    year = rng0.integers(2010, 2026, corpus.n_nodes).astype(np.int32)
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=4, top_k=4,
                                     kmeans_iters=8)
    index = HMGIIndex(cfg, seed=0, device=device)
    index.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
                  for m in corpus.vectors},
                 n_nodes=corpus.n_nodes,
                 edges=(corpus.src, corpus.dst, corpus.edge_type),
                 node_attrs={"year": year})
    print(f"index built on {index.device}: "
          f"{index.memory_usage()['total']/2**20:.2f} MiB")

    # 1b. declarative hybrid query: "find entities (e.g. images) related
    #     via :authored edges to text matches WHERE year > 2020". The
    #     predicate constrains the seed scan, the traversal routing and the
    #     surfaced candidates.
    qtext = corpus.vectors["text"][:4]
    plan = (Q.vector("text", qtext)
              .where(("year", ">", 2020))
              .traverse(2, edge_types=(authored,))
              .topk(8))
    print("plan:", index.explain(plan))
    scores, ids, trace = index.query(plan, trace=True)
    ids = ids.cpu().numpy()
    is_image = np.isin(ids, corpus.node_ids["image"])
    print(f"hits: {int((ids >= 0).sum())} "
          f"({int(is_image.sum())} image entities reached via :authored)")
    print(trace.render())

    # 1c. plans compose: re-score text matches in the image embedding
    #     space, or intersect two seed scans (set ops over candidate sets)
    qimg = corpus.vectors["image"][:4]
    rescored = (Q.vector("text", qtext).traverse(1)
                  .cross_modal("image", qimg, weight=0.4).topk(4))
    both = Q.intersect(Q.vector("text", qtext).topk(32),
                       Q.vector("text", qtext + 0.05).topk(32)).topk(4)
    for p in (rescored, both):
        print("plan:", index.explain(p))
        index.query(p)

    # 2. a small LM (reduced phi4-family config) as the generator
    lm_cfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(lm_cfg, seed=0, device=device)
    engine = RAGEngine(lm_cfg, params, index,
                       EngineConfig(n_slots=8, max_seq=96, retrieve_k=4,
                                    hops=1), device=device)

    # 3. batched requests: retrieve entity context per query, then generate
    #    with continuous batching (slots refill as requests finish)
    rng = np.random.default_rng(2)
    n_requests = 12
    query_vecs = corpus.vectors["text"][rng.integers(0, 700, n_requests)]
    retrieved = engine.retrieve(query_vecs)          # hybrid vector+graph
    t0 = time.perf_counter()
    for rid in range(n_requests):
        prompt = rng.integers(0, lm_cfg.vocab_size, 12)
        engine.submit(rid, prompt, retrieved_ids=retrieved[rid],
                      max_new_tokens=8 + (rid % 3) * 4)   # mixed lengths
    outputs = engine.run_to_completion()
    dt = time.perf_counter() - t0

    done = sum(1 for v in outputs.values() if v)
    toks = sum(len(v) for v in outputs.values())
    print(f"served {done}/{n_requests} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s); engine stats: {engine.stats}")
    if done != n_requests:
        raise SystemExit(f"only {done} of {n_requests} requests finished")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
