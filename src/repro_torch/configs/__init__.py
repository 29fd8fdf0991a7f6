"""Config registry of the port: the index's own config, the five LM
configs of the RAG engine, the four GNN configs (EGNN, NequIP, DimeNet,
Equiformer-v2) and the recsys config (xDeepFM). ``all_cells`` walks the
reference's 40 (arch, shape) cells in its order."""
from __future__ import annotations

import importlib
from typing import Iterator, List, Tuple, Union

from repro_torch.configs.base import (GNNConfig, HMGIConfig, LMConfig,
                                      RecsysConfig, ShapeSpec)

_MODULES = {
    "hmgi": "repro_torch.configs.hmgi",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "egnn": "repro_torch.configs.egnn",
    "nequip": "repro_torch.configs.nequip",
    "dimenet": "repro_torch.configs.dimenet",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "xdeepfm": "repro_torch.configs.xdeepfm",
}
_Config = Union[HMGIConfig, LMConfig, GNNConfig, RecsysConfig]

# the assignment's architectures, in the reference registry's order
ASSIGNED_ARCHS: Tuple[str, ...] = (
    "deepseek-67b", "qwen2-72b", "phi4-mini-3.8b", "mixtral-8x7b",
    "deepseek-v2-lite-16b", "dimenet", "egnn", "nequip", "equiformer-v2",
    "xdeepfm")


def get_config(arch_id: str) -> _Config:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_shapes(arch_id: str) -> List[ShapeSpec]:
    get_config(arch_id)
    return importlib.import_module(_MODULES[arch_id]).SHAPES


def all_cells(include_skipped: bool = True
              ) -> Iterator[Tuple[str, ShapeSpec]]:
    """Every (arch_id, ShapeSpec) cell of the assignment (40 in all)."""
    for arch in ASSIGNED_ARCHS:
        for shape in get_shapes(arch):
            if include_skipped or not shape.skip:
                yield arch, shape


def smoke_config(arch_id: str) -> _Config:
    """Reduced same-family config for CPU tests (the reference's
    ``smoke_config`` widths)."""
    cfg = get_config(arch_id)
    if isinstance(cfg, LMConfig):
        kw = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                  n_kv_heads=min(cfg.n_kv_heads, 2), d_ff=128, vocab_size=512,
                  scan_layers=True, remat=False)
        if cfg.moe:
            kw.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
                      moe_d_ff=64, dense_d_ff=128,
                      n_shared_experts=min(cfg.n_shared_experts, 1))
        if cfg.attention == "mla":
            kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16)
        if cfg.sliding_window:
            kw.update(sliding_window=32)
        return cfg.replace(**kw)
    if isinstance(cfg, GNNConfig):
        return cfg.replace(n_layers=2, d_hidden=16, n_heads=2,
                           l_max=min(cfg.l_max, 2), m_max=min(cfg.m_max, 1),
                           n_spherical=min(cfg.n_spherical, 4),
                           n_radial=min(cfg.n_radial, 4), n_bilinear=4,
                           n_rbf=4)
    if isinstance(cfg, RecsysConfig):
        return cfg.replace(n_sparse=8, embed_dim=4, vocab_per_field=64,
                           cin_layers=(8, 8), mlp_layers=(16, 16))
    return cfg.replace(dim=16, modality_dims={}, n_partitions=4, n_probe=2,
                       kmeans_iters=4, delta_capacity=64, nsw_degree=4,
                       nsw_ef=8)
