"""Serving launcher (the port of ``repro.launch.serve``): builds an HMGI
index over a synthetic multimodal corpus and serves batched hybrid
queries, then an ingest-while-search phase (streaming inserts/deletes
interleaved with queries, adaptive maintenance draining the delta in
bounded steps between batches) and optional RAG generation with
maintenance paced between decode steps.

``python -m repro_torch.launch.serve --n-nodes 2000 --queries 64 [--rag]
[--device cuda|cpu]``

``--rag`` generates with the reference's smoke phi4-mini (head dim 16),
on either device.

On the card unless ``--device`` says otherwise. Durability: ``--data-dir
DIR`` makes the index durable (write-ahead op log + periodic snapshots
under DIR); ``--recover`` restarts from DIR's latest valid snapshot plus
log-tail replay instead of rebuilding — search results are bit-identical
to the pre-crash index.

Observability: all phase timings come from the ``repro_torch.obs``
registry (spans feed named histograms); a span's time ends when its
results are on the host or the card has been synchronised.
``--metrics-out FILE`` dumps the full registry snapshot as JSON at exit.
``main`` returns the readings it prints, as a dict.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import obs
from repro_torch.common.params import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import HMGIIndex
from repro_torch.data.synthetic import (ground_truth_topk, make_corpus,
                                        recall_at_k)


def _wait(device: torch.device) -> None:
    """Blocks until the card's queued work is done (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-nodes", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--hops", type=int, default=2)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--ingest-steps", type=int, default=4,
                    help="ingest-while-search streaming steps (0 = skip)")
    ap.add_argument("--data-dir", type=str, default=None,
                    help="durable mode: op-log + snapshot under this dir")
    ap.add_argument("--recover", action="store_true",
                    help="recover from --data-dir instead of rebuilding")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the obs registry snapshot (JSON) here at exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.recover and not args.data_dir:
        ap.error("--recover requires --data-dir")
    device = resolve_device(args.device, "repro_torch.launch.serve")

    cfg = get_config("hmgi").replace(n_partitions=32, n_probe=8,
                                     kmeans_iters=8, top_k=args.k)
    corpus = make_corpus(n_nodes=args.n_nodes,
                         modality_dims={"text": 64, "image": 96})
    hist = lambda name: obs.histogram(name).summary()      # noqa: E731
    out = {"device": str(device)}
    if args.recover:
        from repro_torch.persistence import recover
        with obs.span("serve.recover"):
            index = recover(cfg, args.data_dir, seed=0, device=device)
            _wait(device)
        out["recover_s"] = hist("serve.recover")["max"] / 1e3
        out["recovery"] = index.metrics()["recovery"]
        print(f"recover: {out['recover_s']:.2f}s  [{out['recovery']}]")
    else:
        if args.data_dir:
            from repro_torch.persistence import DurableHMGIIndex
            index = DurableHMGIIndex(cfg, args.data_dir, seed=0,
                                     device=device)
        else:
            index = HMGIIndex(cfg, seed=0, device=device)
        with obs.span("serve.ingest_build"):
            index.ingest({m: (corpus.node_ids[m], corpus.vectors[m])
                          for m in corpus.vectors}, n_nodes=corpus.n_nodes,
                         edges=(corpus.src, corpus.dst, corpus.edge_type))
            _wait(device)
        out["ingest_build_s"] = hist("serve.ingest_build")["max"] / 1e3
        out["memory_mib"] = index.memory_usage()["total"] / 2 ** 20
        print(f"ingest+build: {out['ingest_build_s']:.2f}s  "
              f"memory: {out['memory_mib']:.1f} MiB")

    rng = np.random.default_rng(1)
    sel = rng.integers(0, len(corpus.vectors["text"]), args.queries)
    q = corpus.vectors["text"][sel] + 0.05 * rng.normal(
        size=(args.queries, 64)).astype(np.float32)

    with obs.span("serve.vector_batch"):
        _, si = index.search(q, "text", k=args.k)
        si = si.cpu().numpy()
    truth = ground_truth_topk(corpus.vectors["text"], corpus.node_ids["text"],
                              q, args.k)
    out["vector_ms_per_q"] = hist("serve.vector_batch")["max"] / args.queries
    out["recall"] = recall_at_k(si, truth)
    print(f"vector search: {out['vector_ms_per_q']:.3f} ms/q  "
          f"recall@{args.k}={out['recall']:.3f}")

    with obs.span("serve.hybrid_batch"):
        index.hybrid_search(q, "text", k=args.k, n_hops=args.hops)
        _wait(device)
    out["hybrid_ms_per_q"] = hist("serve.hybrid_batch")["max"] / args.queries
    print(f"hybrid search ({args.hops} hops): "
          f"{out['hybrid_ms_per_q']:.3f} ms/q")

    # ingest-while-search: streaming writes interleaved with queries; the
    # adaptive maintenance hooks (insert/delete auto-trigger) drain the
    # delta in bounded steps instead of stop-the-world compactions. Worst
    # write stall = the max of the per-step "serve.ingest_step" histogram.
    if args.ingest_steps > 0:
        batch = max(args.n_nodes // 20, 8)
        for step in range(args.ingest_steps):
            wid = rng.integers(0, args.n_nodes, batch).astype(np.int32)
            wv = rng.normal(size=(batch, 64)).astype(np.float32)
            with obs.span("serve.ingest_step"):
                index.insert("text", wid, wv)
                index.delete("text", wid[:batch // 8])
                _wait(device)
            index.search(q[:8], "text", k=args.k)
            _wait(device)
        m = index.modalities["text"]
        out["ingest_worst_stall_ms"] = hist("serve.ingest_step")["max"]
        out["delta"] = int(m.delta.count)
        out["maintenance"] = index.metrics().get("maintenance", "n/a")
        print(f"ingest-while-search: {args.ingest_steps} steps x {batch} "
              f"writes, worst write stall "
              f"{out['ingest_worst_stall_ms']:.1f} ms, "
              f"delta={out['delta']}  maintenance: {out['maintenance']}")

    if args.data_dir:
        with obs.span("serve.snapshot"):
            path = index.snapshot()
        out["snapshot_s"] = hist("serve.snapshot")["max"] / 1e3
        out["last_seq"] = index.last_seq
        print(f"snapshot: {out['snapshot_s']:.2f}s -> {path}  "
              f"(last_seq={index.last_seq})")

    if args.rag:
        from repro_torch.models import lm
        from repro_torch.serving.engine import EngineConfig, RAGEngine
        lcfg = smoke_config("phi4-mini-3.8b")
        params = lm.init_lm(lcfg, 0, device=device)
        eng = RAGEngine(lcfg, params, index,
                        EngineConfig(n_slots=4, max_seq=64, retrieve_k=4,
                                     snapshot_interval=32), device=device)
        rids = eng.retrieve(q[:4])
        for i in range(4):
            eng.submit(i, rng.integers(0, lcfg.vocab_size, 8), rids[i], 8)
        gen = eng.run_to_completion()
        out["rag_generated"] = {k: len(v) for k, v in gen.items()}
        print(f"RAG generated: {out['rag_generated']} stats={eng.stats}")

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(obs.snapshot(), f, indent=2)
        print(f"metrics -> {args.metrics_out}")
    return out


if __name__ == "__main__":
    main()
