"""Carries a reference index's state, and a reference LM's parameters,
into the port.

``index_from_jax_state(tree, meta, device)`` takes the JAX package's
``HMGIIndex.state_tree()`` output, with every leaf passed through
``np.asarray`` (so this module never touches JAX), and returns a port
``HMGIIndex`` holding the same bytes: the int8 slabs, vmin/scale, ids and
counts, the centroids (parked sentinels included), every ``DeltaStore``
field, the fp32 master vectors and ids, the NSW graphs (``nsw/*``), the
workload hits, the write-time partition statistics (``stats/*``), the
graph CSR, communities, boosted weights, attribute columns and the
rerank lane's sparse documents (``sparse/*``).

What does not carry over: the JAX PRNG key cannot seed a
``torch.Generator``, so the port's generator is reseeded from ``seed``,
and later random draws (none on the search path) differ from the
reference's.

``lm_params_from_jax(tree, device)`` takes the reference ``init_lm``'s
params with numpy leaves and returns the port's layout (see
``models/lm.py``): the unstacked ``head_layers`` (a MoE model's dense
first layers) and then the rows of the stacked ``layers`` (leading L
axis) become one list of per-layer dicts in layer order, MLA and MoE
leaves included (the router's fp32 ``wr`` stays fp32); ``embed``,
``final_ln`` and ``head`` are kept. With it both packages compute the
same function.

``gnn_params_from_jax(tree, device)`` takes the reference ``init_model``'s
GNN params with numpy leaves and returns the port's, in the same layout
(EGNN: ``enc``, ``layers[i].{phi_e,phi_x,phi_h}.{w0,b0,w1,b1}``, ``head``).

``adamw_state_from_jax(state, device)`` takes a reference ``AdamWState``
(``step``, ``mu``, ``nu``; numpy leaves) and returns the port's
``train.optimizer.AdamWState``: the int32 step and the fp32 moments in the
params' layout, so a run carries across between steps.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.common.params import resolve_device
from repro_torch.configs.base import HMGIConfig
from repro_torch.core.index import HMGIIndex
from repro_torch.train.optimizer import AdamWState


def index_from_jax_state(tree: Dict[str, np.ndarray], meta: Dict[str, object],
                         device=None, *, cfg: Optional[HMGIConfig] = None,
                         seed: int = 0, mesh=None) -> HMGIIndex:
    """tree/meta: a reference ``state_tree()`` with numpy leaves. cfg: the
    port config to run with (default ``get_config("hmgi")``); a reference
    config converts with ``HMGIConfig(**dataclasses.asdict(ref_cfg))``.
    device, mesh: as for ``HMGIIndex`` (device None = the CUDA device)."""
    cpu = torch.device("cpu")
    # bfloat16 leaves (a 16-bit slab) have no numpy dtype torch reads
    tree = {k: (_leaf(v, cpu) if np.asarray(v).dtype.name == "bfloat16"
                else np.asarray(v)) for k, v in tree.items()}
    index = HMGIIndex(cfg or get_config("hmgi"), mesh=mesh, seed=seed,
                      device=device)
    index.restore_state(tree, meta)
    return index


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a, copy=True).view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(v, fn) for v in node]
    return fn(node)


def lm_params_from_jax(tree: Dict[str, object], device=None) -> Dict[str, object]:
    """tree: a reference ``init_lm`` params dict with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``). device: None = the CUDA device."""
    device = resolve_device(device, "lm_params_from_jax")
    stacked = tree["layers"]
    n_stacked = int(np.asarray(stacked["ln1"]).shape[0])
    out = {k: _leaf(tree[k], device) for k in ("embed", "final_ln", "head")
           if k in tree}
    out["layers"] = ([_map(lp, lambda a: _leaf(a, device))
                      for lp in tree.get("head_layers", [])]
                     + [_map(stacked, lambda a, i=i: _leaf(np.asarray(a)[i],
                                                           device))
                        for i in range(n_stacked)])
    return out


def gnn_params_from_jax(tree: Dict[str, object], device=None) -> Dict[str, object]:
    """tree: a reference GNN ``init_model`` params dict with numpy leaves
    (e.g. ``jax.tree.map(np.asarray, params)``). device: None = the CUDA
    device."""
    device = resolve_device(device, "gnn_params_from_jax")
    return _map(tree, lambda a: _leaf(a, device))


def adamw_state_from_jax(state, device=None):
    """state: a reference ``AdamWState`` (or a ``(step, mu, nu)`` tuple)
    with numpy leaves. device: None = the CUDA device."""
    device = resolve_device(device, "adamw_state_from_jax")
    step, mu, nu = state
    return AdamWState(
        step=_leaf(np.asarray(step, np.int32), device),
        mu=_map(mu, lambda a: _leaf(a, device)),
        nu=_map(nu, lambda a: _leaf(a, device)))
