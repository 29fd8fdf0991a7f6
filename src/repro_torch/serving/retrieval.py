"""Cross-request retrieval micro-batching for the serving path (the port's
copy of ``repro.serving.retrieval``).

One ``(1, k)`` retrieval per request would pay one probe assignment, one
scan launch and one top-k per *request* instead of per *batch*. This module
batches them:

- ``MicroBatcher`` — a leader/follower combining funnel: requests arriving
  within a small window (plus everything that queued up while the previous
  batch was in flight) are stacked into one ``(Q, k)`` call through
  ``repro_torch.query.executor.search_bucketed``, Q padded to a pow2
  bucket. Requests are grouped by plan fingerprint — a mixed-plan batch
  falls back to one bucketed call per group — and exact-duplicate queries
  inside a group are computed once and fanned out (dedup is exact-byte:
  serving a *nearby* query's results would be wrong).
- ``RetrievalService`` — admission (per-tenant token bucket, shared
  ``scheduler.AdmissionController``) -> hot-result cache lookup
  (``cache.HotResultCache``, version-stamped) -> micro-batch -> cache
  store. ``batching=False`` keeps the same bucketed entry (identical
  bytes) without the cross-request funnel — the bench's baseline mode.

What holds across batch sizes: the reference promises byte-identical
rows whether a request rode solo or in a full bucket, which rests on how
XLA:CPU computes pow2 buckets >= 2. The port promises only what its tests
show: on the CPU, a request's ids equal its solo ids and its scores agree
to fp32 rounding (``tests/test_torch_serving.py``). On the card the cuBLAS
rescore and the cuSPARSE hops may reduce in an order that depends on Q;
byte identity there is ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.query.executor import search_bucketed
from repro_torch.serving.cache import HotResultCache
from repro_torch.serving.scheduler import AdmissionController


@dataclasses.dataclass(frozen=True)
class RetrievalPlan:
    """The plan fingerprint: everything that selects the plan of a
    retrieval, *except* the query values. Hashable — it keys micro-batch
    groups and cache entries. ``where`` must be the frozen spelling
    (``freeze_where``)."""
    modality: str
    k: int
    n_hops: int = 0
    n_probe: Optional[int] = None
    where: Optional[tuple] = None
    impl: str = "auto"


def freeze_where(where) -> Optional[tuple]:
    """Hashable spelling of a predicate: one (col, op, value) clause stays
    a tuple, a conjunction list becomes a tuple of clause tuples."""
    if where is None:
        return None
    if isinstance(where[0], (list, tuple)):
        return tuple(tuple(c) for c in where)
    return tuple(where)


def _thaw_where(frozen):
    if frozen is None:
        return None
    if isinstance(frozen[0], tuple):
        return [list(c) for c in frozen]
    return frozen


def run_plan(index, plan: RetrievalPlan,
             q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One bucketed retrieval for ``plan`` over the (Q, d) batch ``q``."""
    return search_bucketed(index, q, plan.modality, k=plan.k,
                           n_probe=plan.n_probe,
                           where=_thaw_where(plan.where),
                           n_hops=plan.n_hops, impl=plan.impl)


class _Pending:
    """One in-flight request riding a micro-batch."""
    __slots__ = ("plan", "q", "scores", "ids", "error", "ready")

    def __init__(self, plan: RetrievalPlan, q: np.ndarray):
        self.plan = plan
        self.q = q
        self.scores = None
        self.ids = None
        self.error: Optional[BaseException] = None
        self.ready = False


class MicroBatcher:
    """Leader/follower combining funnel over ``search_bucketed``.

    The first request to find no leader becomes one: it waits ``window_s``
    for followers to pile on, takes the whole pending list (releasing
    leadership first, so arrivals during execution elect the next leader
    and batches pipeline), executes one bucketed call per plan group, and
    wakes everyone. Followers park on the condition variable until their
    entry is marked ready. With ``window_s == 0`` batches still form under
    load — everything that arrived while the previous batch was in flight
    rides the next one."""

    def __init__(self, index, *, window_s: float = 0.001,
                 max_batch: int = 64, floor: int = 2):
        self.index = index
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.floor = int(floor)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._leader = False

    # ------------------------------------------------------------ internals
    def _execute(self, batch: List[_Pending]) -> None:
        """Run one taken batch: group by plan, dedup exact query bytes
        within each group, one bucketed call per group. Called with the
        lock NOT held (device work must never run under it)."""
        groups: Dict[RetrievalPlan, List[_Pending]] = {}
        for p in batch:
            groups.setdefault(p.plan, []).append(p)
        if len(groups) > 1:
            obs.counter("serving.batch.mixed_plan").inc()
        for plan, members in groups.items():
            uniq: Dict[bytes, int] = {}
            rows: List[np.ndarray] = []
            slot: List[int] = []
            for p in members:
                key = p.q.tobytes()
                at = uniq.get(key)
                if at is None:
                    at = uniq[key] = len(rows)
                    rows.append(p.q)
                else:
                    obs.counter("serving.batch.dedup_hits").inc()
                slot.append(at)
            sv, si = run_plan(self.index, plan, np.concatenate(rows))
            obs.histogram("serving.batch_q",
                          obs.COUNT_BUCKETS).observe(len(members))
            obs.counter("serving.batch.calls").inc()
            obs.counter("serving.batch.queries").inc(len(members))
            for p, at in zip(members, slot):
                p.scores, p.ids = sv[at:at + 1], si[at:at + 1]

    def _take_batch_locked(self) -> List[_Pending]:
        """Claim up to ``max_batch`` pending entries and release
        leadership (caller holds the lock)."""
        batch = self._pending[:self.max_batch]
        self._pending = self._pending[len(batch):]
        self._leader = False
        if self._pending:
            # leftovers need a new leader; wake a parked follower to claim
            self._cv.notify_all()
        return batch

    # ------------------------------------------------------------------ API
    def search(self, plan: RetrievalPlan,
               q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Retrieve one (1, d) query through the funnel. Blocks until the
        batch it rode completes; returns (scores (1, k), ids (1, k))."""
        mine = _Pending(plan, np.ascontiguousarray(q, np.float32).reshape(1, -1))
        with self._lock:
            self._pending.append(mine)
            lead = not self._leader
            if lead:
                self._leader = True
        if lead:
            if self.window_s > 0.0:
                time.sleep(self.window_s)      # collect followers
            while True:
                with self._lock:
                    batch = self._take_batch_locked()
                try:
                    self._execute(batch)
                except BaseException as e:     # propagate to every rider
                    for p in batch:
                        p.error = e
                with self._lock:
                    for p in batch:
                        p.ready = True
                    self._cv.notify_all()
                    if mine.ready:
                        break
                    # our entry rode past max_batch: lead the next round
                    if not self._leader:
                        self._leader = True
                        continue
                # another thread took over leadership; park as a follower
                self._wait_ready(mine)
                break
        else:
            self._wait_ready(mine)
        if mine.error is not None:
            raise mine.error
        return mine.scores, mine.ids

    def _wait_ready(self, mine: _Pending) -> None:
        with self._lock:
            while not mine.ready:
                # a parked follower may be elected leader for leftovers
                # (the previous leader overflowed max_batch and quit)
                if self._pending and not self._leader:
                    self._leader = True
                    batch = self._take_batch_locked()
                    try:
                        self._execute_unlocked(batch)
                    finally:
                        for p in batch:
                            p.ready = True
                        self._cv.notify_all()
                    continue
                # staticcheck: disable=HMG202 (Condition.wait releases _lock while blocking; parked followers stall nobody)
                self._cv.wait(timeout=0.1)

    def _execute_unlocked(self, batch: List[_Pending]) -> None:
        """Drop the lock around device work, reacquire after (only called
        from ``_wait_ready``, which holds it)."""
        self._lock.release()
        try:
            self._execute(batch)
        except BaseException as e:
            for p in batch:
                p.error = e
        finally:
            self._lock.acquire()


class RetrievalService:
    """The serving retrieval path: admission -> cache -> micro-batch.

    ``search`` returns ``None`` when admission rejects (the caller sheds
    the request); otherwise (scores (1, k), ids (1, k)) — the same request
    retrieved alone, to the extent the module docstring states.
    ``search_many`` is the caller-already-batched entry (the RAG engine's
    per-tick retrieval): one bucketed call for the cache-missing rows."""

    def __init__(self, index, *, batching: bool = True,
                 window_s: float = 0.001, max_batch: int = 64,
                 cache: Optional[HotResultCache] = None,
                 admission: Optional[AdmissionController] = None,
                 floor: int = 2):
        self.index = index
        self.batching = bool(batching)
        self.cache = cache
        self.admission = admission
        self.floor = int(floor)
        self._batcher = MicroBatcher(index, window_s=window_s,
                                     max_batch=max_batch, floor=floor)

    def _admit(self, tenant: str) -> bool:
        if self.admission is not None and not self.admission.try_admit(tenant):
            obs.counter("serving.rejected").inc()
            return False
        return True

    def search(self, plan: RetrievalPlan, q: np.ndarray,
               tenant: str = "default"
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self._admit(tenant):
            return None
        q = np.ascontiguousarray(q, np.float32).reshape(1, -1)
        # the version is read BEFORE computing: if a mutation lands
        # mid-flight the stored stamp is already stale and the entry never
        # hits — a result can be cached under at most the state it saw
        version = self.index.version
        if self.cache is not None:
            hit = self.cache.lookup(plan, q, version)
            if hit is not None:
                return hit
        if self.batching:
            scores, ids = self._batcher.search(plan, q)
        else:
            scores, ids = run_plan(self.index, plan, q)
        if self.cache is not None:
            self.cache.store(plan, q, version, scores, ids)
        return scores, ids

    def search_many(self, plan: RetrievalPlan, queries: np.ndarray,
                    tenant: str = "default"
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Caller-batched retrieval: cache per row, one bucketed call for
        the misses. Admission charges one token per row."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        for _ in range(q.shape[0]):
            if not self._admit(tenant):
                return None
        version = self.index.version
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * q.shape[0]
        misses: List[int] = []
        for i in range(q.shape[0]):
            row = q[i:i + 1]
            hit = (self.cache.lookup(plan, row, version)
                   if self.cache is not None else None)
            if hit is not None:
                out[i] = hit
            else:
                misses.append(i)
        if misses:
            sv, si = run_plan(self.index, plan, q[misses])
            obs.histogram("serving.batch_q",
                          obs.COUNT_BUCKETS).observe(len(misses))
            for j, i in enumerate(misses):
                got = (sv[j:j + 1], si[j:j + 1])
                out[i] = got
                if self.cache is not None:
                    self.cache.store(plan, q[i:i + 1], version, *got)
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]))
