"""Runs ``chip_smoke.py``'s mesh phase alone, on the card, from a checkout:
the inputs ``gnn_train`` hands it (EGNN's ogbn-products graph, seeded
parameters, a ``LocalExec``, the local forward's p50 and one local step's
loss and grad norm), then ``phase_mesh``. On a host with two cards or more
the phase's ``mesh_cards`` runs EGNN's ring with one data shard a card.

    python tools/mesh_phase_torch.py

It runs the checkout it sits in. The phase prints its own ``[mesh]``,
``[mesh.cards]`` and ``[mesh.checks]`` lines; a ``[mesh_phase]`` line
adds the set-up's and the phase's seconds.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> dict:
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    from repro_torch.train.optimizer import init_adamw

    t_all = time.perf_counter()
    cs.phase_device()
    sops._lib()
    build_s = time.perf_counter() - t_all
    cfg = get_config("egnn")
    dims = {s.name: s.dims for s in get_shapes("egnn")}["ogb_products"]
    g = gd.make_flat_graph(dims["n_nodes"], dims["n_edges"], dims["d_feat"],
                           seed=0)
    params = gd.init_model(cfg, 0, dims["d_feat"])
    ex = LocalExec(g, cs.GNN_CHUNK_EDGES)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            gd.full_graph_loss(cfg, params, g, ex=ex)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _, _, m = gd.make_train_step(cfg, "full_graph")(
        params, init_adamw(params), {"graph": g, "exec": ex})
    local_step = (float(m["loss"]), float(m["grad_norm"]))
    del m
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t_all
    t0 = time.perf_counter()
    launches = cs.phase_mesh(params, g, ex, float(np.median(times[1:])),
                             local_step)
    out = dict(build_s=build_s, setup_s=setup_s,
               local_forward_ms=times, local_step=local_step,
               launches=list(launches), phase_s=time.perf_counter() - t0,
               total_s=time.perf_counter() - t_all)
    print("[mesh_phase] " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
