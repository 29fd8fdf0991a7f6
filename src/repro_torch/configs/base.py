"""Configurations of the port: the reference's ``HMGIConfig``, ``LMConfig``,
``GNNConfig`` and ``ShapeSpec``.

Same field names and defaults as the JAX package (its ``ArchConfig`` base
fields are folded into each class), so a reference config converts with
``HMGIConfig(**dataclasses.asdict(ref_cfg))``,
``LMConfig(**dataclasses.asdict(ref_cfg))`` or
``GNNConfig(**dataclasses.asdict(ref_cfg))``, and a snapshot's config
fingerprint (``persistence.snapshot.config_fingerprint``) is the same in
both packages. Fields the port does not act on yet (sharding; the LM's
MLA, MoE and training knobs) are kept for that round trip; the code raises
``NotImplementedError`` where one of them would change behaviour (see
``core/index.py`` and ``models/lm.py``).
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
    # NSW graph refinement layer (core/nsw.py)
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
    # adaptive maintenance (maintenance/): maint_auto routes insert/delete
    # through HMGIIndex.maintain's bounded passes instead of compact()
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
    # durability (persistence/): fsync batch of the op log, snapshots kept
    wal_sync_every: int = 1
    snapshot_keep: int = 2
    # observability: sync the device at span exit (honest stage times)
    obs_sync_spans: bool = False
    dtype: str = "float32"

    def replace(self, **kw) -> "HMGIConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LMConfig:
    """A transformer LM (the RAG engine's generator). The port serves dense
    GQA (optionally with QKV bias and a sliding window); ``attention="mla"``
    and ``moe=True`` are kept for the round trip and refused by
    ``models/lm.py``."""
    arch_id: str = ""
    family: str = "lm"
    source: str = ""
    sharding_overrides: Dict[str, Any] = field(default_factory=dict)
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # attention variant
    attention: str = "gqa"       # "gqa" | "mla" (mla: not ported)
    sliding_window: int = 0      # >0 => SWA
    # MLA (not ported)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE (not ported)
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # execution (scan/remat: training knobs of the reference, kept for the
    # round trip)
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (matches the reference's init)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        if self.attention == "mla":
            attn = (d * self.kv_lora_rank + d * self.qk_rope_head_dim
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.v_head_dim)
                    + d * self.n_heads
                    * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        ffn_dense = 3 * d * self.d_ff
        total = 0
        for layer in range(L):
            total += attn + 2 * d  # two rmsnorm scales
            if self.moe and layer >= self.first_dense_layers:
                e_ff = self.moe_d_ff or self.d_ff
                total += self.n_experts * 3 * d * e_ff
                total += self.n_shared_experts * 3 * d * e_ff
                total += d * self.n_experts  # router
            elif self.moe and self.first_dense_layers:
                total += 3 * d * (self.dense_d_ff or self.d_ff)
            else:
                total += ffn_dense
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += d  # final norm
        return total


@dataclass(frozen=True)
class GNNConfig:
    """A message-passing GNN. The port runs ``model="egnn"``; the DimeNet,
    NequIP and Equiformer-v2 fields are kept for the round trip."""
    arch_id: str = ""
    family: str = "gnn"
    source: str = ""
    sharding_overrides: Dict[str, Any] = field(default_factory=dict)
    model: str = ""              # "dimenet" | "egnn" | "nequip" | "equiformer_v2"
    n_layers: int = 4
    d_hidden: int = 64
    # dimenet
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    # nequip / equiformer
    l_max: int = 2
    m_max: int = 0               # equiformer-v2 eSCN truncation
    n_rbf: int = 8
    cutoff: float = 5.0
    n_heads: int = 8
    d_feat_in: int = 0           # input node-feature dim (0 => atom-type embed)
    n_species: int = 32
    dtype: str = "float32"

    def replace(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)
