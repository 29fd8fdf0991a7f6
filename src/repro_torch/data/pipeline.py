"""Host data pipeline: deterministic batches with background prefetch and
restart-safe skipping (the port of ``repro.data.pipeline``, plain numpy
and threads, with the reference's draws: the same seed and step give the
same arrays, bit for bit).

Determinism contract (fault tolerance): batch ``i`` is a pure function of
(seed, i), so a restarted trainer resumes mid-epoch by fast-forwarding the
step counter — no data-state checkpointing needed. The streams hand out
numpy arrays; the trainer's ``to_device`` moves them to the card.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMStream:
    """Deterministic synthetic LM token stream (per-step fresh RNG)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1), dtype=np.int64)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class SyntheticRecsysStream:
    def __init__(self, n_fields: int, vocab: int, batch: int, seed: int = 0):
        self.f, self.v, self.b, self.seed = n_fields, vocab, batch, seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        ids = rng.integers(0, self.v, (self.b, self.f), dtype=np.int64)
        # click labelled by a planted sparse rule so accuracy can move
        y = ((ids[:, 0] + ids[:, 1]) % 7 < 3).astype(np.int32)
        return {"ids": ids.astype(np.int32), "labels": y}


def _drain(q: Optional["queue.Queue"]) -> None:
    if q is None:
        return
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class Prefetcher:
    """Background-thread prefetch of ``stream.batch_at(step)``, yielding
    ``(step, batch)`` tuples in step order.

    Concurrency contract (guarded-by ``_lock``: ``q``/``step``/``_stop``/
    ``_thread`` — HMG201/HMG204): the worker receives its queue, stop
    event and start step as *arguments* and never reads them off ``self``,
    so restarts can swap them without publication races. ``close()`` stops
    the worker *before* the final drain: set the stop event, then
    drain-while-joining under a bounded deadline (the worker may be blocked
    mid-``put`` — draining unblocks it; a put landing after the last drain
    cannot happen because the join completes first). ``start()`` after
    ``close()`` resumes from the next unconsumed step — the restart path
    the determinism contract (batch ``i`` is a pure function of (seed, i))
    exists for.
    """

    JOIN_TIMEOUT_S = 5.0

    def __init__(self, stream, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.depth = depth
        self._lock = threading.Lock()
        self.q: Optional["queue.Queue"] = None
        self.step = start_step
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self.start()

    def start(self) -> None:
        """(Re)start the worker from the next unconsumed step. Idempotent
        while a worker is alive."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            q: "queue.Queue" = queue.Queue(maxsize=self.depth)
            stop = threading.Event()
            t = threading.Thread(target=self._work, args=(stop, q, self.step),
                                 daemon=True)
            self.q = q
            self._stop = stop
            self._thread = t
            t.start()

    def _work(self, stop: threading.Event, q: "queue.Queue", s: int) -> None:
        while not stop.is_set():
            try:
                q.put((s, self.stream.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with self._lock:
            q = self.q
        if q is None:
            raise StopIteration          # closed and not restarted
        item = q.get()                   # blocks OUTSIDE the lock (HMG202)
        with self._lock:
            self.step = item[0] + 1      # restart point: next unconsumed
        return item

    def close(self) -> None:
        """Stop the worker, join it (bounded), and leave the queue empty.
        Safe to call repeatedly; ``start()`` afterwards resumes."""
        with self._lock:
            thread, stop, q = self._thread, self._stop, self.q
            self._thread = None
        if stop is not None:
            stop.set()
        if thread is not None:
            deadline = time.monotonic() + self.JOIN_TIMEOUT_S
            while thread.is_alive() and time.monotonic() < deadline:
                _drain(q)                # unblock a worker stuck in put()
                thread.join(timeout=0.1)
            if thread.is_alive():
                raise RuntimeError(
                    "Prefetcher worker failed to stop within "
                    f"{self.JOIN_TIMEOUT_S}s")
        # worker has exited: nothing can enqueue after this drain
        _drain(q)
        with self._lock:
            if self.q is q:
                self.q = None
