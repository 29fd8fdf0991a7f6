"""Times ``HMGIIndex.insert`` of the PyTorch port at a serving size: batches
that update existing ids, batches of new ids and batches of both, each
through the facade with the device synchronised after the call, beside one
copy of the fp32 master rows (what a write now pays to publish new rows
instead of rewriting them in place).

    python tools/time_upsert_torch.py [--n 1048576] [--dim 384] [--batch 256]
        [--reps 15] [--src DIR] [--device cuda]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (default:
this one's), so two trees can be timed in one session, each in its own
process. The kinds of batch take turns, ``--reps`` rounds of each; the
last line of the output is one JSON object of their p50 and mean in ms.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent
                                         / "src"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    n, d, b = args.n, args.dim, args.batch
    n_new = args.reps * (b + b // 2)    # ids past n: the batches that grow
    index = HMGIIndex(get_config("hmgi"), seed=0, device=dev)
    index.ingest({"text": (np.arange(n, dtype=np.int32),
                           rng.standard_normal((n, d), dtype=np.float32))},
                 n + n_new)
    sync()
    fresh = iter(range(n, n + n_new))
    times = {"update": [], "new": [], "mixed": []}
    for _ in range(args.reps):
        for kind in times:
            old = rng.choice(n, b, replace=False)
            new = [next(fresh) for _ in
                   range({"update": 0, "new": b, "mixed": b // 2}[kind])]
            ids = {"update": old, "new": np.asarray(new),
                   "mixed": np.concatenate([old[:b - len(new)], new])}[kind]
            rows = rng.standard_normal((b, d), dtype=np.float32)
            sync()
            t0 = time.perf_counter()
            index.insert("text", ids.astype(np.int32), rows)
            sync()
            times[kind].append((time.perf_counter() - t0) * 1e3)
    m = index.modalities["text"]
    copy_ms = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        m.vectors.clone()
        sync()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"src": args.src, "n": n, "dim": d, "batch": b, "reps": args.reps,
           "device": str(dev),
           "master_rows_bytes": m.vectors.numel() * m.vectors.element_size(),
           "master_copy_ms": dict(p50=float(np.median(copy_ms)),
                                  mean=float(np.mean(copy_ms)))}
    for kind, ts in times.items():
        out[f"insert_{kind}_ms"] = dict(p50=float(np.median(ts)),
                                        mean=float(np.mean(ts)),
                                        max=float(np.max(ts)))
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
