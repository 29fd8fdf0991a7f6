"""Continuous-batching scheduler: fixed decode slots, admission queue,
per-slot sequence state (the Orca/vLLM iteration-level scheduling model,
sized for a fixed-shape decode step over a shared KV cache), plus
per-tenant token-bucket admission control shared by the decode and
retrieval paths. The port's own copy of ``repro.serving.scheduler``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch import obs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (L,) int32
    max_new_tokens: int = 16
    generated: Optional[List[int]] = None
    done: bool = False
    submitted_s: float = 0.0           # perf_counter at submit (queue wait)
    tenant: str = "default"            # admission-control accounting key


# ------------------------------------------------------- per-tenant admission
@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Token-bucket parameters for one tenant: ``rate`` tokens/second
    refill into a bucket capped at ``burst``; each admitted request costs
    one token. ``rate == burst == 0`` is the sanctioned zero-quota spelling
    (always rejected)."""
    rate: float
    burst: float


class AdmissionController:
    """Per-tenant token-bucket admission (one shared instance gates both
    the decode queue and the retrieval path).

    ``try_admit`` is the whole protocol: refill the tenant's bucket by
    elapsed-time x rate (capped at burst), spend one token if available.
    Unknown tenants use ``default_quota``; with no default they are always
    admitted (admission control is opt-in per tenant). Outcomes land in
    the obs registry per tenant (``serving.tenant.<t>.admitted`` /
    ``.rejected``) plus the aggregate ``serving.admission.*`` counters.

    ``now`` is injectable so tests drive the clock deterministically. One
    lock guards the bucket map."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None):
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        self._lock = threading.Lock()
        self._buckets: Dict[str, List[float]] = {}  # tenant -> [tokens, ts]

    def _quota(self, tenant: str) -> Optional[TenantQuota]:
        return self.quotas.get(tenant, self.default_quota)

    def try_admit(self, tenant: str = "default", *,
                  now: Optional[float] = None) -> bool:
        quota = self._quota(tenant)
        if quota is None:
            obs.counter(f"serving.tenant.{tenant}.admitted").inc()
            obs.counter("serving.admission.admitted").inc()
            return True
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = [float(quota.burst), now]
                self._buckets[tenant] = bucket
            tokens, last = bucket
            tokens = min(float(quota.burst),
                         tokens + max(now - last, 0.0) * quota.rate)
            ok = tokens >= 1.0
            bucket[0] = tokens - 1.0 if ok else tokens
            bucket[1] = now
        verdict = "admitted" if ok else "rejected"
        obs.counter(f"serving.tenant.{tenant}.{verdict}").inc()
        obs.counter(f"serving.admission.{verdict}").inc()
        return ok


@dataclasses.dataclass
class Slot:
    active: bool = False
    rid: int = -1
    pos: int = 0                       # next position to decode
    remaining: int = 0


class ContinuousBatcher:
    """Admits requests into free slots; evicts finished ones each step.

    With an ``AdmissionController`` attached, ``submit`` first spends one
    of the request's tenant's tokens; with ``max_queue > 0`` the wait
    queue is bounded and an arrival past the bound is rejected (load
    shedding at the door instead of unbounded queue growth). A rejected
    request is marked done with no generated tokens and counted under
    ``serving.rejected`` (+ the per-tenant counter)."""

    def __init__(self, n_slots: int,
                 admission: Optional[AdmissionController] = None,
                 max_queue: int = 0):
        self.slots = [Slot() for _ in range(n_slots)]
        self.queue: Deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self.admission = admission
        self.max_queue = int(max_queue)

    def submit(self, req: Request) -> bool:
        req.generated = []
        req.submitted_s = time.perf_counter()
        if self.max_queue and len(self.queue) >= self.max_queue:
            req.done = True
            obs.counter("serving.rejected").inc()
            obs.counter(f"serving.tenant.{req.tenant}.rejected").inc()
            obs.counter("serving.rejected_queue_full").inc()
            return False
        if self.admission is not None \
                and not self.admission.try_admit(req.tenant):
            req.done = True
            obs.counter("serving.rejected").inc()
            return False
        self.requests[req.rid] = req
        self.queue.append(req)
        obs.counter("serving.submitted").inc()
        obs.gauge("serving.queue_depth").set(len(self.queue))
        return True

    def admit(self) -> List[int]:
        """Fills free slots from the queue; returns newly admitted slot ids.

        Requests with ``max_new_tokens <= 0`` complete at admission (empty
        ``generated``) and never occupy a slot — a slot would still decode
        one token for them (``remaining`` would go 0 -> -1 only after the
        first ``record_tokens``)."""
        newly = []
        for i, s in enumerate(self.slots):
            if s.active:
                continue
            while self.queue and self.queue[0].max_new_tokens <= 0:
                self.queue.popleft().done = True
            if not self.queue:
                break
            req = self.queue.popleft()
            s.active = True
            s.rid = req.rid
            s.pos = len(req.prompt)
            s.remaining = req.max_new_tokens
            newly.append(i)
            obs.counter("serving.admitted").inc()
            wait_s = time.perf_counter() - req.submitted_s
            obs.observe_ms("serving.queue_wait", wait_s)
            obs.observe_ms(f"serving.tenant.{req.tenant}.queue_wait", wait_s)
        if newly:
            obs.gauge("serving.queue_depth").set(len(self.queue))
        return newly

    def record_prefill_token(self, slot: int, token: int):
        """The first generated token comes from the prefill logits, before
        any decode step: record it (and possibly finish the request) so the
        generated stream matches sequential per-request decoding exactly.
        ``pos`` stays at the prompt length — that is where this token's KV
        will be written when it is fed to the next decode step."""
        s = self.slots[slot]
        req = self.requests[s.rid]
        req.generated.append(int(token))
        s.remaining -= 1
        if s.remaining <= 0:
            req.done = True
            s.active = False
            obs.counter("serving.evicted").inc()
            obs.counter("serving.completed").inc()

    def record_tokens(self, tokens: np.ndarray):
        """tokens (n_slots,) — one decoded token per slot this step."""
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            req = self.requests[s.rid]
            req.generated.append(int(tokens[i]))
            s.pos += 1
            s.remaining -= 1
            if s.remaining <= 0:
                req.done = True
                s.active = False
                obs.counter("serving.evicted").inc()
                obs.counter("serving.completed").inc()

    @property
    def any_active(self) -> bool:
        return any(s.active for s in self.slots) or bool(self.queue)

    def active_mask(self) -> np.ndarray:
        return np.array([s.active for s in self.slots])


class MaintenanceDriver:
    """Paces adaptive index maintenance between decode steps.

    Serving interleaves ingest with search: without maintenance the delta
    store fills and every query's scan slows; with synchronous compaction a
    full rebuild stalls an entire decode tick. ``tick`` runs
    ``index.maintain(budget=budget_rows)`` — bounded work by construction —
    every ``interval``-th tick, so the ingest-while-search steady state pays
    a small, constant maintenance tax per tick instead of rare large stalls.
    A serving loop calls ``tick()`` between decode steps; a no-op maintain
    costs one O(K) planning pass.

    When the index is durable (has a ``snapshot()`` method) and
    ``snapshot_interval > 0``, every ``snapshot_interval``-th tick also
    writes a versioned snapshot — bounding crash-recovery replay at roughly
    one snapshot interval's worth of ops. A no-change snapshot is a no-op
    inside ``DurableHMGIIndex.snapshot`` itself."""

    def __init__(self, index, budget_rows: int = 256, interval: int = 4,
                 snapshot_interval: int = 0):
        self.index = index
        self.budget_rows = budget_rows
        self.interval = max(int(interval), 1)
        self.snapshot_interval = max(int(snapshot_interval), 0)
        self.ticks = 0
        self.runs = 0
        self.snapshots = 0
        self.last_report = None

    def tick(self):
        self.ticks += 1
        if self.index is None:
            return None
        if (self.snapshot_interval
                and self.ticks % self.snapshot_interval == 0
                and hasattr(self.index, "snapshot")):
            if self.index.snapshot() is not None:
                self.snapshots += 1
        if self.ticks % self.interval:
            return None
        # "maintenance.stall" is the decode-tick stall maintenance causes:
        # the inline maintain() wall time as seen from the serving loop
        # (index.maintain's own histogram counts every pass, including the
        # mutation-path auto-triggers)
        with obs.span("maintenance.stall"):
            self.last_report = self.index.maintain(budget=self.budget_rows)
        self.runs += 1
        return self.last_report
