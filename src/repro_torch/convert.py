"""Carries a reference index's state into the port.

``index_from_jax_state(tree, meta, device)`` takes the JAX package's
``HMGIIndex.state_tree()`` output, with every leaf passed through
``np.asarray`` (so this module never touches JAX), and returns a port
``HMGIIndex`` holding the same bytes: the int8 slabs, vmin/scale, ids and
counts, the centroids (parked sentinels included), every ``DeltaStore``
field, the fp32 master vectors and ids, the workload hits, the graph CSR,
communities, boosted weights and attribute columns.

What does not carry over:

- ``stats/*`` (write-time partition statistics) are accepted and dropped:
  ``PartitionStats`` is not ported yet (ROADMAP Queue 1 item 11).
- ``nsw/*`` and ``sparse/*`` raise ``NotImplementedError`` (item 10).
- The JAX PRNG key cannot seed a ``torch.Generator``: the port's generator
  is reseeded from ``seed``, so later random draws (none on the search
  path) differ from the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import HMGIConfig
from repro_torch.core.index import HMGIIndex


def index_from_jax_state(tree: Dict[str, np.ndarray], meta: Dict[str, object],
                         device=None, *, cfg: Optional[HMGIConfig] = None,
                         seed: int = 0) -> HMGIIndex:
    """tree/meta: a reference ``state_tree()`` with numpy leaves. cfg: the
    port config to run with (default ``get_config("hmgi")``); a reference
    config converts with ``HMGIConfig(**dataclasses.asdict(ref_cfg))``.
    device: as for ``HMGIIndex`` (None = the CUDA device)."""
    for key in tree:
        if key.startswith("sparse/") or "/nsw/" in key:
            raise NotImplementedError(
                f"state key {key!r}: NSW and sparse-rerank state are not "
                "ported to repro_torch yet (ROADMAP.md Queue 1 item 10)")
    tree = {k: np.asarray(v) for k, v in tree.items()
            if "/stats/" not in k}
    index = HMGIIndex(cfg or get_config("hmgi"), seed=seed, device=device)
    index.restore_state(tree, meta)
    return index
