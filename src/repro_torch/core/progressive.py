"""Progressive (anytime) query execution (paper §3.4): deliver a coarse
result immediately and refine within a latency budget — n_probe doubles per
round; every round's result is exact over the partitions probed so far, so
quality is monotone (each round's candidate set is a superset).
"""
from __future__ import annotations

import time
from typing import Iterator, NamedTuple, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import ivf as ivf_mod
from repro_torch.core.ivf import IVFIndex


class AnytimeResult(NamedTuple):
    scores: torch.Tensor
    ids: torch.Tensor
    n_probe: int
    round: int
    elapsed_s: float


def progressive_search(index: IVFIndex, queries, *, k: int,
                       probe_schedule: Sequence[int] = (1, 2, 4, 8, 16),
                       budget_s: Optional[float] = None,
                       node_pass: Optional[torch.Tensor] = None
                       ) -> Iterator[AnytimeResult]:
    """Yields monotonically improving results; stops at budget, at the
    schedule's end, or once every partition is probed.

    queries: (Q, d), a tensor or an array (moved to the index's device).
    node_pass: optional (N,) visibility mask threaded into every round's
    scan — anytime refinement must honour the same MVCC/tombstone view as a
    one-shot search, or a round could resurface deleted rows.

    The budget is charged with *work* time: each round's scan+merge is
    measured on its own, up to a device sync (the ``progressive.round``
    histogram), and the check compares the accumulated round time against
    ``budget_s``. Time spent between rounds — the consumer's own work while
    the generator is suspended at ``yield`` — does not cost refinement.
    ``elapsed_s`` reports the accumulated work time."""
    dev = index.ids.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    work_s = 0.0
    best = None
    for rnd, np_ in enumerate(probe_schedule):
        np_ = min(np_, index.n_partitions)
        t0 = time.perf_counter()
        sv, si = ivf_mod.search(index, queries, n_probe=np_, k=k,
                                node_pass=node_pass)
        if best is None:
            best = (sv, si)
        else:
            best = ivf_mod.dedup_merge_topk(best[0], best[1], sv, si, k)
        sv, si = best
        # the sync stays *inside* the measured round: a round's cost is its
        # device work, not just its launches
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        work_s += dt
        obs.observe_ms("progressive.round", dt)
        obs.counter("progressive.rounds").inc()
        yield AnytimeResult(sv, si, np_, rnd, work_s)
        if budget_s is not None and work_s >= budget_s:
            return
        if np_ >= index.n_partitions:
            return
