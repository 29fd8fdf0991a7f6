"""Streaming ingestion under MVCC with *adaptive* maintenance, on the
PyTorch port: inserts, updates and deletes with live queries — the delta
drains in bounded incremental steps (no manual compact, no stop-the-world
rebuild), cold partitions merge away, and workload skew splits the hot
partition in place. The NSW refine lane stays consistent: updated rows
never surface with their stale scores.

    PYTHONPATH=src python examples/torch_dynamic_updates.py            # CUDA
    PYTHONPATH=src python examples/torch_dynamic_updates.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import HMGIIndex
from repro_torch.data.synthetic import make_corpus


def main(device):
    corpus = make_corpus(n_nodes=1000, modality_dims={"text": 48}, seed=0)
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=4, top_k=5,
                                     delta_capacity=128,
                                     maint_chunk=32, maint_budget_rows=64,
                                     use_nsw_refine=True, nsw_degree=8)
    index = HMGIIndex(cfg, seed=0, device=device)
    index.ingest({"text": (corpus.node_ids["text"], corpus.vectors["text"])},
                 n_nodes=corpus.n_nodes, edges=(corpus.src, corpus.dst))

    # 1. streaming writes: maint_auto (the default) lets insert/delete
    #    trigger bounded maintenance — the delta watermark stays bounded
    #    without a single explicit compact
    rng = np.random.default_rng(0)
    for step in range(8):
        ids = rng.integers(0, corpus.n_nodes, 40).astype(np.int32)  # some
        vecs = rng.normal(size=(40, 48)).astype(np.float32)   # are updates
        index.insert("text", ids, vecs)
        # live query against the newest version of a just-written id
        _, found = index.search(vecs[:1], "text", k=1)
        fresh = int(found[0, 0]) == int(ids[0])
        delta_rows = int(index.modalities["text"].delta.count)
        print(f"step {step}: delta={delta_rows:4d} "
              f"fresh-read={'OK' if fresh else 'STALE!'}  "
              f"maintenance: {index.metrics().get('maintenance', 'n/a')}")

    # 2. an explicit budgeted pass: plan + apply ≤64 rows of work
    report = index.maintain("text", budget=64)
    print(f"explicit maintain: {report.describe()}")

    # 3. hollow out a partition with deletes -> delete's auto-trigger merges
    #    it into its nearest sibling and parks the slot (deleted ids never
    #    resurrect; the parked slot is reused by the next split)
    m = index.modalities["text"]
    p = int(np.argmin(m.ivf.counts.cpu().numpy()))
    victims = m.ivf.ids[p].cpu().numpy()
    victims = victims[victims >= 0]
    index.delete("text", victims)
    print(f"after deleting partition {p}'s rows: "
          f"{index.metrics()['maintenance']}")
    print(f"live partitions: {int(np.sum(~m.stats.parked))}/"
          f"{cfg.n_partitions}")

    # 4. workload skew triggers an in-place split of the hot partition
    #    (only its rows move, byte-identically — no full rebuild)
    m.workload.hits[:] = 0
    m.workload.hits[int(np.argmax(m.ivf.counts.cpu().numpy()))] = 50_000
    if index.maybe_repartition("text"):
        print("workload skew detected -> hot partition split (bounded work)")
    hist = index.metrics()["obs"]["histograms"]
    print(f"final delta size: {int(m.delta.count)}; live partitions: "
          f"{int(np.sum(~m.stats.parked))}/{cfg.n_partitions}; "
          f"insert p50 {hist['index.insert']['p50']:.2f} ms, "
          f"maintain p50 {hist['index.maintain']['p50']:.2f} ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
