"""Logical -> physical compiler for the declarative query engine.

``compile_plan`` walks a ``repro_torch.query.ast.Plan`` and emits a
``PhysicalPlan`` with every cost decision resolved against the index and
the cost model (core/cost_model.py), as the reference planner does:

- **Where placement** — the chain's predicates compile once to one (N,)
  ``node_pass`` mask; ``plan_filtered_scan`` picks *pushdown* vs
  *oversample-then-post-filter* for the seed scan. Traversal routing and
  candidate surfacing always carry the mask.
- **Probe widths** — the explicit ``n_probe`` wins, else a ``min_recall``
  constraint resolves through ``select_plan``, else the config default;
  clamped to the *live* (unparked) partition count, read from the
  modality's ``PartitionStats``. Seed scan width is ``plan_seed_width``.
- **Device layout** — per seed stage, ``index.device_layout``
  (``plan_device_layout``) decides whether the stable scan runs
  single-device or row-sharded over the index's mesh: sharded when the
  quantized slab exceeds the per-device budget, forced by
  ``cfg.shard_layout`` either way. The two layouts scan the same
  candidate set in the same stored representation, so the choice never
  changes results — only where the work lands.
- **Fusion representation** — per traverse stage, ``plan_fusion`` chooses
  candidate-sparse vs dense fusion; ``fusion_repr`` forces a choice.

``PhysicalPlan.describe()`` renders the chosen plan (``HMGIIndex.explain``)
in the reference's exact words.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import partitioner
from repro_torch.core import traversal as trav_mod
from repro_torch.core.cost_model import (DeviceLayoutPlan, FilteredScanPlan,
                                         estimate_selectivity,
                                         plan_filtered_scan, plan_fusion,
                                         plan_seed_width, select_plan)
from repro_torch.query.ast import CrossModal, Q, SetOp, Traverse, Where


@dataclasses.dataclass(eq=False)
class PSeed:
    modality: str
    query: torch.Tensor                    # (Q, d), L2-normalised
    k: int                                 # seed scan width
    n_probe: int
    impl: str
    filter_plan: Optional[FilteredScanPlan]  # None = unfiltered scan
    layout: DeviceLayoutPlan = DeviceLayoutPlan("single", 1)


@dataclasses.dataclass(eq=False)
class PTraverse:
    n_hops: int
    damping: float
    edge_type_mask: Optional[torch.Tensor]  # (T,) fp32, None = all types
    k_fuse: int                            # stage output width
    frontier: int                          # traversal candidates admitted
    repr: str                              # "sparse" | "dense"


@dataclasses.dataclass(eq=False)
class PRescore:
    modality: str
    query: torch.Tensor                    # (Q, d2), L2-normalised
    weight: float


@dataclasses.dataclass(eq=False)
class PSetOp:
    kind: str                              # "union" | "intersect"
    left: "PhysicalPlan"
    right: "PhysicalPlan"


@dataclasses.dataclass(eq=False)
class PhysicalPlan:
    source: Union[PSeed, PSetOp]
    stages: Tuple[Any, ...]
    k: int
    node_pass: Optional[torch.Tensor]      # (N,) bool, None = no predicate
    where: Tuple[Any, ...]                 # raw predicates (reporting)

    def describe(self) -> str:
        parts = []
        if isinstance(self.source, PSetOp):
            parts.append(f"{self.source.kind}[{self.source.left.describe()}"
                         f" | {self.source.right.describe()}]")
        else:
            s = self.source
            f = ("" if s.filter_plan is None else
                 f" filter={s.filter_plan.mode}"
                 f"(sel={s.filter_plan.selectivity:.3f})")
            lay = ("" if s.layout.layout == "single" else
                   f" layout=sharded(x{s.layout.n_shards})")
            parts.append(f"seed[{s.modality} k={s.k} probe={s.n_probe}{f}{lay}]")
        for st in self.stages:
            if isinstance(st, PTraverse):
                t = "" if st.edge_type_mask is None else " typed"
                parts.append(f"traverse[h={st.n_hops}{t} fuse={st.repr}"
                             f" k_fuse={st.k_fuse} F={st.frontier}]")
            else:
                parts.append(f"rescore[{st.modality} w={st.weight:g}]")
        parts.append(f"topk({self.k})")
        return " -> ".join(parts)


def compile_plan(index, plan, *, k: Optional[int] = None,
                 node_pass: Optional[torch.Tensor] = None,
                 fusion_repr: Optional[str] = None) -> PhysicalPlan:
    """index: the HMGIIndex the plan will run against. k: fallback terminal
    width when the plan has no ``topk``. node_pass: precompiled predicate
    mask. fusion_repr: force "sparse"/"dense" fusion (None = cost-based).

    One ``query.plan`` span per top-level compile; set-op branches recurse
    through ``_compile_plan``, so the histogram counts whole compiles."""
    with obs.span("query.plan"):
        return _compile_plan(index, plan, k=k, node_pass=node_pass,
                             fusion_repr=fusion_repr)


def _compile_plan(index, plan, *, k: Optional[int] = None,
                  node_pass: Optional[torch.Tensor] = None,
                  fusion_repr: Optional[str] = None) -> PhysicalPlan:
    if isinstance(plan, Q):
        plan = plan.plan
    cfg = index.cfg
    k = int(plan.k or k or cfg.top_k)

    preds = tuple(p for st in plan.stages if isinstance(st, Where)
                  for p in st.predicates)
    if node_pass is None and preds:
        node_pass = index._node_pass(list(preds))
    logical = [st for st in plan.stages if not isinstance(st, Where)]
    downstream = any(isinstance(st, (Traverse, CrossModal)) for st in logical)

    if isinstance(plan.source, SetOp):
        branch_k = plan_seed_width(k, True)
        source: Union[PSeed, PSetOp] = PSetOp(
            plan.source.kind,
            _compile_plan(index, plan.source.left, k=branch_k,
                          fusion_repr=fusion_repr),
            _compile_plan(index, plan.source.right, k=branch_k,
                          fusion_repr=fusion_repr))
        c = (source.left.k + source.right.k if source.kind == "union"
             else source.left.k)
    else:
        vs = plan.source
        m = index.modalities[vs.modality]
        n_probe = vs.n_probe
        if n_probe is None and vs.min_recall is not None:
            n_probe = select_plan(index.cost_model, n=int(m.ids.shape[0]),
                                  d=int(m.vectors.shape[1]),
                                  min_recall=vs.min_recall).n_probe
        # parked partitions hold no rows and their sentinel centroids rank
        # last: clamping to the live count scans exactly the same rows
        n_live = (int(np.sum(~m.stats.parked)) if m.stats is not None
                  else partitioner.live_partitions(m.ivf.centroids))
        n_probe = min(int(n_probe or cfg.n_probe), max(n_live, 1))
        k_seed = plan_seed_width(k, downstream)
        fplan = None
        if node_pass is not None:
            fplan = plan_filtered_scan(
                estimate_selectivity(node_pass.cpu().numpy()), k_seed,
                n_rows=int(m.ids.shape[0]),
                oversample=cfg.filter_oversample,
                prefilter_max_sel=cfg.filter_prefilter_max_sel)
        source = PSeed(vs.modality, index._norm_queries(vs.query), k_seed,
                       int(n_probe or cfg.n_probe), vs.impl, fplan,
                       index.device_layout(vs.modality))
        c = k_seed

    stages = []
    for st in logical:
        if isinstance(st, Traverse):
            if index.graph is None:
                raise ValueError("Traverse needs a graph: ingest(edges=...)")
            hops = cfg.max_hops if st.hops is None else int(st.hops)
            fp = plan_fusion(index.n_nodes, k, c)
            mask = trav_mod.as_edge_mask(st.edge_types, index.device)
            stages.append(PTraverse(hops, float(st.damping), mask,
                                    fp.k_fuse, fp.frontier,
                                    fusion_repr or fp.repr))
            if hops > 0:
                c = fp.k_fuse
        else:  # CrossModal (width-preserving re-score)
            if st.modality not in index.modalities:
                raise KeyError(f"unknown modality {st.modality!r}")
            stages.append(PRescore(st.modality,
                                   index._norm_queries(st.query),
                                   float(st.weight)))
    return PhysicalPlan(source, tuple(stages), k, node_pass, preds)
