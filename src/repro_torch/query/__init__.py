"""Declarative hybrid query engine: AST + builder (ast), cost-based
logical->physical compiler (planner), staged executor (executor).

    from repro_torch.query import Q
    scores, ids = index.query(Q.vector("text", q).traverse(2).topk(10))
"""
from repro_torch.query.ast import (CrossModal, Plan, Q, SetOp, Traverse,
                                   VectorSeed, Where)
