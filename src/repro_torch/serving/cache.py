"""Version-invalidated LRU hot-result cache for the serving retrieval path.

Entries are keyed on ``(plan fingerprint, quantized query signature)`` and
stamped with the index version (``HMGIIndex.version``) they were computed
at. A lookup hits only when all three agree:

- the plan fingerprint (modality, k, hops, probes, predicate, impl) — two
  different plans never share an entry;
- the stored *exact* fp32 query bytes — the signature is a float16
  quantisation, so two nearby queries can collide on a key; serving one
  the other's results would be wrong by construction, hence the entry
  keeps the exact bytes and a byte mismatch is a miss (the resident
  entry stays: the colliding key owner keeps its slot until evicted);
- the index version — every mutation that can change a result (insert,
  delete, compaction, *applied* maintenance, repartition, attribute swap)
  bumps the stamp, so a stale entry is structurally unservable. Version
  mismatches evict the entry on sight (it can never hit again).

Concurrency: one lock (``_lock``) guards the LRU dict and the counters.
Stored arrays are immutable by convention (the cache hands back the same
numpy objects it was given). The port's own copy of
``repro.serving.cache``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs


def query_signature(q: np.ndarray) -> bytes:
    """Quantized signature of one query batch: float16-rounded bytes.

    Deliberately lossy — nearby fp32 queries may share a signature, which
    is what makes the key small and the hit rate tolerant of transport
    jitter. Correctness never rests on it: the entry's exact-byte check
    does (see module docstring)."""
    return np.ascontiguousarray(q, np.float16).tobytes()


class HotResultCache:
    """LRU (scores, ids) cache over ``(plan fingerprint, query signature,
    index version)`` with exact-byte verification on hit."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (plan, signature) -> (exact query bytes, version, scores, ids)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._stores = 0

    def lookup(self, plan, q: np.ndarray,
               version: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The cached (scores, ids) for ``plan`` over ``q`` at ``version``,
        or None. A version mismatch evicts the entry (it can never hit
        again); an exact-byte mismatch leaves it (signature collision —
        the resident owner may still hit)."""
        q = np.ascontiguousarray(q, np.float32)
        key = (plan, query_signature(q))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                obs.counter("serving.cache.miss").inc()
                return None
            qbytes, ver, scores, ids = entry
            if ver != version:
                del self._entries[key]
                obs.counter("serving.cache.invalidated").inc()
                obs.counter("serving.cache.miss").inc()
                return None
            if qbytes != q.tobytes():
                obs.counter("serving.cache.collision").inc()
                obs.counter("serving.cache.miss").inc()
                return None
            self._entries.move_to_end(key)
            obs.counter("serving.cache.hit").inc()
            return scores, ids

    def store(self, plan, q: np.ndarray, version: int,
              scores: np.ndarray, ids: np.ndarray) -> None:
        """Insert (LRU-evicting past capacity). ``version`` must be the
        index version read *before* the result was computed: if a mutation
        landed mid-flight the stamp is already stale and the entry simply
        never hits — conservative, never wrong."""
        q = np.ascontiguousarray(q, np.float32)
        key = (plan, query_signature(q))
        entry = (q.tobytes(), int(version),
                 np.asarray(scores), np.asarray(ids))
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._stores += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                obs.counter("serving.cache.evicted").inc()
            obs.gauge("serving.cache.size").set(len(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            obs.gauge("serving.cache.size").set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list:
        """Current keys in LRU order (oldest first) — test introspection."""
        with self._lock:
            return list(self._entries)
