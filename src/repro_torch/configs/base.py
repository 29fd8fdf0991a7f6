"""HMGI's configuration: the reference's ``HMGIConfig`` and ``ShapeSpec``.

Same field names and defaults as the JAX package (its ``ArchConfig`` base
fields are folded in), so a reference config converts with
``HMGIConfig(**dataclasses.asdict(ref_cfg))``. Fields the port does not act
on yet (NSW, maintenance, sharding, durability, obs) are kept for that
round trip; the facade raises ``NotImplementedError`` where one of them
would change behaviour (see ``core/index.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One serving-shape cell of a configuration."""
    name: str
    kind: str
    dims: Dict[str, int] = field(default_factory=dict)
    skip: bool = False
    skip_reason: str = ""

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


@dataclass(frozen=True)
class HMGIConfig:
    """Configuration of the Hybrid Multimodal Graph Index itself."""
    arch_id: str = "hmgi"
    family: str = "index"
    source: str = ""
    sharding_overrides: Dict[str, Any] = field(default_factory=dict)
    dim: int = 384                         # embedding dim (per modality override)
    modalities: Tuple[str, ...] = ("text", "image", "audio", "video")
    modality_dims: Dict[str, int] = field(default_factory=dict)
    n_partitions: int = 64                 # K-means partitions per modality (Eq. 1)
    kmeans_iters: int = 16
    n_probe: int = 8                       # partitions scanned per query
    top_k: int = 10
    # quantization (Eq. 2)
    quant_bits: int = 8                    # 16 | 8 | 4
    adaptive_quant: bool = True
    memory_budget_bytes: int = 0           # 0 = unlimited
    # NSW graph refinement layer (not ported yet)
    nsw_degree: int = 16
    nsw_ef: int = 64
    use_nsw_refine: bool = False
    # delta store (MVCC)
    delta_capacity: int = 4096
    compact_threshold: float = 0.5         # compact when delta half full
    delta_rescore_margin: int = 16         # extra int8-scan survivors rescored
                                           # in fp32
    # hybrid fusion (Eq. 3)
    w_vector: float = 0.6
    w_graph: float = 0.4
    adaptive_weights: bool = True
    max_hops: int = 2
    # cost model (Eq. 5)
    cost_alpha: float = 1.0
    cost_beta: float = 0.01
    cost_gamma: float = 0.1
    # adaptive maintenance (not ported yet: the port needs maint_auto=False)
    maint_auto: bool = True
    maint_budget_rows: int = 1024
    maint_chunk: int = 256
    maint_delta_pressure: float = 0.5
    maint_heat_imbalance: float = 4.0
    maint_split_min_fill: float = 0.75
    maint_merge_max_fill: float = 0.10
    maint_drift_threshold: float = 0.35
    # attribute-filtered search (predicate pushdown vs oversampling)
    filter_prefilter_max_sel: float = 0.5  # pushdown when sel <= this
    filter_oversample: float = 3.0         # initial k inflation when not
    # sharded execution path (not ported yet)
    shard_layout: str = "auto"
    shard_device_budget_bytes: int = 256 << 20
    # durability (not ported yet)
    wal_sync_every: int = 1
    snapshot_keep: int = 2
    # observability (not ported yet)
    obs_sync_spans: bool = False
    dtype: str = "float32"

    def replace(self, **kw) -> "HMGIConfig":
        return dataclasses.replace(self, **kw)
