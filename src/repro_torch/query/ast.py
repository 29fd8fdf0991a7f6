"""Logical query AST + the fluent ``Q`` builder — HMGI's declarative hybrid
query surface (the NaviX / TigerVector query class: vector stages, graph
traversals, relational predicates, and set operations composing freely).

A *plan* is a chain: a source (a ``VectorSeed`` scan or a ``SetOp`` over two
sub-plans) followed by stages (``Traverse``, ``CrossModal``), optionally
constrained by ``Where`` predicates and terminated by ``.topk(k)`` (stored
as ``Plan.k``). Nothing here
touches the index — compilation to physical stages (probe widths, predicate
pushdown vs post-filter, sparse vs dense fusion) happens in
``repro_torch/query/planner.py``; execution in ``repro_torch/query/executor.py``.

``Where`` is declarative and position-independent within its chain: all
predicates of a chain conjoin and constrain *every* stage of that chain —
the seed scan (pushdown or planned oversampling), traversal routing
(excluded nodes neither receive nor forward mass) and candidate surfacing —
exactly the semantics of the facade's ``where=``. A chain whose source is a
``SetOp`` applies its own predicates to the merged candidate set as a
post-filter (each branch carries its own ``Where`` scope) and to every later
stage.

    from repro_torch.query import Q
    plan = (Q.vector("text", q)
              .where(("year", ">", 2020))
              .traverse(2, edge_types=(AUTHORED,))
              .topk(10))
    scores, ids = index.query(plan)
    print(index.explain(plan))     # the compiled physical plan
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True, eq=False)
class VectorSeed:
    """ANNS seed scan: top candidates for ``query`` in ``modality``.

    n_probe: partitions probed (None -> planner: cost-model choice via
    ``min_recall`` when given, else the config default)."""
    modality: str
    query: Any                          # (Q, d) array-like
    n_probe: Optional[int] = None
    min_recall: Optional[float] = None
    impl: str = "auto"                  # IVF probe path: kernel | einsum | auto


@dataclasses.dataclass(frozen=True, eq=False)
class Traverse:
    """h-hop typed traversal from the current candidate set, fused back into
    the candidate scores (Eq. 3). ``edge_types`` is an iterable of edge-type
    ids (Cypher's ``[:REL_TYPE]``) or a prebuilt (T,) mask array; None = all
    types. hops=None -> config ``max_hops``."""
    hops: Optional[int] = None
    edge_types: Any = None
    damping: float = 0.85


@dataclasses.dataclass(frozen=True, eq=False)
class Where:
    """Relational predicates, (column, op, value) tuples AND-combined with
    every other Where of the chain (see graph_store.NodeAttributes)."""
    predicates: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class CrossModal:
    """Re-score the current candidate set in a second modality's embedding
    space: new = (1-weight)·current + weight·sim(query2, emb_modality[id]).
    Candidates without an embedding in ``modality`` keep only the
    (1-weight)·current term (their cross-modal similarity reads as 0)."""
    modality: str
    query: Any
    weight: float = 0.5


@dataclasses.dataclass(frozen=True, eq=False)
class SetOp:
    """Candidate-set combinator over two sub-plans.

    union:     ids from either side; duplicate ids keep the higher score.
    intersect: ids present on both sides; score = mean of the two."""
    kind: str                 # "union" | "intersect"
    left: "Plan"
    right: "Plan"


Source = Union[VectorSeed, SetOp]


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    source: Source
    stages: Tuple[Any, ...] = ()
    k: Optional[int] = None           # terminal TopK (None -> cfg.top_k)


def _norm_predicates(predicates) -> Tuple[Any, ...]:
    """Accepts the facade's ``where`` spellings: one (col, op, value) tuple,
    a sequence of them, or None."""
    if not predicates:
        return ()
    out = []
    for p in predicates:
        if p is None:
            continue
        if isinstance(p, tuple) and len(p) == 3 and isinstance(p[0], str):
            out.append(p)
        else:
            out.extend(q for q in p if q is not None)
    return tuple(out)


class Q:
    """Fluent plan builder. Start with ``Q.vector`` (or combine plans with
    ``Q.union`` / ``Q.intersect``), chain stages, finish with ``.topk(k)``."""

    __slots__ = ("plan",)

    def __init__(self, plan: Plan):
        self.plan = plan

    # ------------------------------------------------------------- sources
    @classmethod
    def vector(cls, modality: str, query, *, n_probe: Optional[int] = None,
               min_recall: Optional[float] = None, impl: str = "auto") -> "Q":
        """ANNS seed source. query: (Q, d_modality) array-like (the planner
        L2-normalises). n_probe: partitions probed (None -> cost model via
        min_recall when given, else cfg default; always clamped to the live
        partition count). impl: IVF probe path ("kernel"/"einsum"/"auto")."""
        return cls(Plan(VectorSeed(modality, query, n_probe, min_recall,
                                   impl)))

    @staticmethod
    def union(a: "Q", b: "Q") -> "Q":
        """Candidate-set union of two plans: ids from either side, duplicate
        ids keep the higher score."""
        return Q(Plan(SetOp("union", a.plan, b.plan)))

    @staticmethod
    def intersect(a: "Q", b: "Q") -> "Q":
        """Candidate-set intersection: ids present on both sides, score =
        mean of the two sides' scores."""
        return Q(Plan(SetOp("intersect", a.plan, b.plan)))

    # -------------------------------------------------------------- stages
    def _append(self, stage) -> "Q":
        return Q(dataclasses.replace(self.plan,
                                     stages=self.plan.stages + (stage,)))

    def traverse(self, hops: Optional[int] = None, *, edge_types=None,
                 damping: float = 0.85) -> "Q":
        """h-hop graph traversal from the current candidates, fused back by
        Eq. 3. hops=None -> cfg.max_hops; edge_types: edge-type ids or a
        prebuilt (T,) mask (None = all types)."""
        return self._append(Traverse(hops, edge_types, damping))

    def where(self, *predicates) -> "Q":
        """Relational constraint: (column, op, value) tuples (or sequences
        thereof), AND-conjoined with every other Where of the chain and
        enforced at every stage. A no-op with no predicates."""
        preds = _norm_predicates(predicates)
        if not preds:
            return self
        return self._append(Where(preds))

    def cross_modal(self, modality: str, query, *, weight: float = 0.5) -> "Q":
        """Width-preserving re-score in a second modality's embedding space:
        new = (1-weight)·current + weight·sim(query, emb[id]); candidates
        without a (live) embedding there read sim = 0."""
        return self._append(CrossModal(modality, query, weight))

    def topk(self, k: int) -> "Q":
        """Terminal width: execution returns (scores (Q, k), ids (Q, k)),
        scores descending, (-inf, -1) on empty slots."""
        return Q(dataclasses.replace(self.plan, k=int(k)))
