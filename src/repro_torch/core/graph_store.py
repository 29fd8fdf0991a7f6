"""Knowledge-graph store: CSR adjacency + typed/weighted edges + node payloads.

HMGI's relational side: entities are nodes, relationships are typed
weighted edges. Traversal operators live in ``core/traversal.py``.

``NodeAttributes`` is the relational *predicate* side: a small fixed set of
int/categorical columns per global node id, held column-major on the
device, so "WHERE node.category == X" compiles to one gather + compare and
pushes down into the vector scans (core/ivf.py, core/delta.py) and the
traversal mask (core/traversal.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.params import resolve_device


class GraphStore(NamedTuple):
    indptr: torch.Tensor       # (N+1,) int32 CSR row pointers (by src)
    indices: torch.Tensor      # (E,) int32 dst node per edge
    src: torch.Tensor          # (E,) int32 src node per edge
    edge_type: torch.Tensor    # (E,) int32
    edge_weight: torch.Tensor  # (E,) fp32
    node_modality: torch.Tensor  # (N,) int32 — modality id of each node's embedding

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(int(a.numel()) * a.element_size() for a in self)


def from_edges(n_nodes: int, src: np.ndarray, dst: np.ndarray,
               edge_type: Optional[np.ndarray] = None,
               edge_weight: Optional[np.ndarray] = None,
               node_modality: Optional[np.ndarray] = None,
               make_undirected: bool = False,
               device=None) -> GraphStore:
    """Host-side construction: sorts edges by src into CSR, on ``device``
    (None = the CUDA device; raises without one)."""
    device = resolve_device(device, "graph_store.from_edges")
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    et = np.zeros_like(src) if edge_type is None else np.asarray(edge_type, np.int32)
    ew = np.ones(len(src), np.float32) if edge_weight is None else np.asarray(edge_weight, np.float32)
    if make_undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        et = np.concatenate([et, et])
        ew = np.concatenate([ew, ew])
    order = np.argsort(src, kind="stable")
    src, dst, et, ew = src[order], dst[order], et[order], ew[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    nm = (np.zeros(n_nodes, np.int32) if node_modality is None
          else np.asarray(node_modality, np.int32))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GraphStore(indptr=t(indptr), indices=t(dst), src=t(src),
                      edge_type=t(et), edge_weight=t(ew), node_modality=t(nm))


def degree(g: GraphStore) -> torch.Tensor:
    return g.indptr[1:] - g.indptr[:-1]


def edge_type_lut(edge_types: Iterable[int], device=None) -> torch.Tensor:
    """Compiles a Cypher-style ``[:REL_A|:REL_B]`` filter — an iterable of
    edge-type ids — into a (T,) fp32 mask (indexed by edge type; excluded
    types carry zero weight). T = max requested id + 1; the traversal
    treats types beyond the mask as excluded. device: None = the CUDA
    device."""
    device = resolve_device(device, "graph_store.edge_type_lut")
    raw = np.asarray(list(edge_types))
    if raw.size and not np.issubdtype(raw.dtype, np.integer):
        # a float-valued sequence is almost certainly a *mask* spelled as a
        # list — reinterpreting it as type ids would silently invert the
        # filter; masks must be passed as tensors
        raise ValueError("edge_types must be integer type ids; pass a "
                         "(T,) mask as a tensor, not a list")
    types = np.unique(raw.astype(np.int64))
    if types.size == 0:
        raise ValueError("empty edge-type set")
    if types.min() < 0:
        raise ValueError("edge-type ids must be non-negative")
    lut = np.zeros(int(types.max()) + 1, np.float32)
    lut[types] = 1.0
    return torch.from_numpy(lut).to(device)


# ---------------------------------------------------------------------------
# Node attributes + predicates (the relational WHERE clause)
# ---------------------------------------------------------------------------

# where-clause ops. "in" takes an iterable of ints (categorical value set,
# compiled to a boolean lookup table over the column's domain).
_OPS = ("==", "!=", "<", "<=", ">", ">=", "in")

# one predicate: (column, op, value), e.g. ("category", "==", 3). A sequence
# of predicates is a conjunction (AND).
Predicate = Tuple[str, str, Union[int, Iterable[int]]]


@dataclasses.dataclass(frozen=True)
class CompiledPredicate:
    """``value`` is an int for comparison ops; ``valueset`` is a bool lookup
    table over [0, domain) for "in" (out-of-range values fail)."""
    col: int
    op: str
    value: Optional[int] = None
    valueset: Optional[torch.Tensor] = None


class NodeAttributes:
    """Columnar int/categorical attributes keyed by global node id.

    values: (C, N) int32 on the device; ``columns`` maps name -> row."""

    def __init__(self, columns: Dict[str, int], values: torch.Tensor):
        self.columns = dict(columns)
        self.values = values

    @classmethod
    def from_columns(cls, n_nodes: int, cols: Dict[str, np.ndarray],
                     device=None) -> "NodeAttributes":
        """(C, N) int32 columns on ``device`` (None = the CUDA device)."""
        device = resolve_device(device, "NodeAttributes.from_columns")
        names = list(cols)
        mat = np.zeros((len(names), n_nodes), np.int32)
        for i, name in enumerate(names):
            v = np.asarray(cols[name], np.int32)
            if v.shape != (n_nodes,):
                raise ValueError(
                    f"column {name!r}: shape {v.shape} != ({n_nodes},)")
            mat[i] = v
        return cls({n: i for i, n in enumerate(names)},
                   torch.from_numpy(mat).to(device))

    @property
    def n_nodes(self) -> int:
        return self.values.shape[1]

    def column(self, name: str) -> torch.Tensor:
        return self.values[self.columns[name]]

    def compile_where(self, where) -> Tuple[CompiledPredicate, ...]:
        """Normalises a where clause (one predicate tuple or a sequence of
        them, AND-combined) into compiled form."""
        if where is None:
            return ()
        if isinstance(where, tuple) and len(where) == 3 \
                and isinstance(where[0], str):
            where = [where]
        out = []
        for col, op, value in where:
            if op not in _OPS:
                raise ValueError(f"unknown predicate op {op!r} (one of {_OPS})")
            ci = self.columns[col]
            if op == "in":
                vals = np.asarray(sorted(set(int(v) for v in value)), np.int64)
                if vals.size == 0:
                    raise ValueError(f"empty value set for column {col!r}")
                if vals.min() < 0:
                    raise ValueError("'in' value sets must be non-negative")
                lut = np.zeros(int(vals.max()) + 1, bool)
                lut[vals] = True
                out.append(CompiledPredicate(
                    ci, op, valueset=torch.from_numpy(lut).to(self.values.device)))
            else:
                out.append(CompiledPredicate(ci, op, value=int(value)))
        return tuple(out)

    def node_pass(self, where) -> Optional[torch.Tensor]:
        """Evaluates a where clause to an (N,) bool mask (None = no filter)."""
        preds = self.compile_where(where)
        if not preds:
            return None
        return eval_predicates(self.values, preds)


def mask_pass(node_pass: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gathers a (max_id+1,) predicate mask at (possibly -1-padded) id
    tensors: True iff the id is valid AND passes."""
    ok = node_pass[ids.clamp(0, node_pass.shape[0] - 1).long()]
    return (ids >= 0) & ok


def eval_predicates(values: torch.Tensor,
                    preds: Sequence[CompiledPredicate]) -> torch.Tensor:
    """(C, N) attribute matrix × compiled conjunction -> (N,) bool."""
    mask = torch.ones(values.shape[1], dtype=torch.bool, device=values.device)
    for p in preds:
        col = values[p.col]
        if p.op == "in":
            dom = p.valueset.shape[0]
            hit = p.valueset[col.clamp(0, dom - 1).long()]
            mask &= hit & (col >= 0) & (col < dom)
        elif p.op == "==":
            mask &= col == p.value
        elif p.op == "!=":
            mask &= col != p.value
        elif p.op == "<":
            mask &= col < p.value
        elif p.op == "<=":
            mask &= col <= p.value
        elif p.op == ">":
            mask &= col > p.value
        else:
            mask &= col >= p.value
    return mask
