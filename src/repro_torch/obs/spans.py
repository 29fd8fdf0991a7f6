"""Trace spans: named, nestable wall-clock timers feeding the registry.

A span is a context manager that times its body with ``perf_counter`` and
records the duration (milliseconds) into the histogram of the same name:

    with span("query.seed_scan") as sp:
        sv, si = run_seed(index, p, node_pass)
        sp.fence((sv, si))

Spans are host-side only — they wrap *calls that launch* device work.
Because CUDA launches are asynchronous, a naive timer charges device work
to whichever later span happens to wait first. ``sp.fence(x)`` fixes
attribution: when sync-spans is on (``set_sync_spans(True)``), the span's
exit synchronises the CUDA device of every tensor in the fenced value, so
device time lands in the span that launched it. With the flag off (the
default), ``fence`` stores nothing and exit does no sync — spans add only
two clock reads and a histogram insert, cheap enough to leave always-on.

Nesting/parenting is per-thread (``threading.local``): a ``trace()``
context installs a collector that assembles completed spans into a
printable tree, returned to callers via the facades' ``trace=`` option.
Span exit always runs (context-manager protocol), so a raise inside the
body still closes the span and records its duration.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import torch

from .metrics import registry

_SYNC_SPANS = False


def set_sync_spans(on: bool) -> None:
    """Enable CUDA synchronisation of fenced values at span exit (honest
    device-time attribution, at the cost of serialising dispatch)."""
    global _SYNC_SPANS
    _SYNC_SPANS = bool(on)


def sync_spans() -> bool:
    return _SYNC_SPANS


class SpanNode:
    """One completed span in a trace tree."""

    __slots__ = ("name", "duration_ms", "children", "error")

    def __init__(self, name: str):
        self.name = name
        self.duration_ms = float("nan")
        self.children: List["SpanNode"] = []
        self.error: Optional[str] = None

    def find(self, name: str) -> Optional["SpanNode"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def render(self, indent: int = 0) -> str:
        mark = f"  !{self.error}" if self.error else ""
        lines = [f"{'  ' * indent}{self.name:<{max(1, 28 - 2 * indent)}}"
                 f" {self.duration_ms:8.3f} ms{mark}"]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"SpanNode({self.name}, {self.duration_ms:.3f} ms)"

    def __str__(self) -> str:
        return self.render()


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: List[SpanNode] = []   # open spans, innermost last
        self.trace: Optional["Trace"] = None


_STATE = _ThreadState()


class Trace:
    """Collector for one traced request. ``root`` is the first top-level
    span completed while the trace was active (the facade's outermost
    span); ``render()`` prints the whole tree."""

    def __init__(self):
        self.roots: List[SpanNode] = []

    @property
    def root(self) -> Optional[SpanNode]:
        return self.roots[0] if self.roots else None

    def find(self, name: str) -> Optional[SpanNode]:
        for r in self.roots:
            hit = r.find(name)
            if hit is not None:
                return hit
        return None

    def render(self) -> str:
        return "\n".join(r.render() for r in self.roots)

    def __str__(self) -> str:
        return self.render()


class trace:
    """Context manager installing a per-thread span collector:

        with trace() as t:
            index.search(q, "text")
        print(t.render())

    Only one trace per thread at a time; nested ``trace()`` reuses the
    outer collector.
    """

    def __init__(self):
        self._owner = False
        self.trace: Optional[Trace] = None

    def __enter__(self) -> Trace:
        if _STATE.trace is None:
            _STATE.trace = Trace()
            self._owner = True
        self.trace = _STATE.trace
        return self.trace

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._owner:
            _STATE.trace = None


class span:
    """Timed, nestable span. Records duration_ms into the histogram named
    ``name``; attaches to the enclosing span's trace node when a trace is
    active. Exception-safe: exit runs and records even when the body
    raises (the node is marked with the exception type)."""

    __slots__ = ("name", "_t0", "_node", "_fenced")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._node: Optional[SpanNode] = None
        self._fenced: Any = None

    def fence(self, value: Any) -> Any:
        """Mark ``value`` (a tensor, or tuples/lists/dicts of them) to have
        its CUDA devices synchronised at span exit when sync-spans is on;
        returns it unchanged so call sites can fence in-line. No-op (stores
        nothing) when off."""
        if _SYNC_SPANS:
            self._fenced = value
        return value

    def __enter__(self) -> "span":
        node = SpanNode(self.name)
        st = _STATE
        if st.trace is not None:
            if st.stack:
                st.stack[-1].children.append(node)
            else:
                st.trace.roots.append(node)
        st.stack.append(node)
        self._node = node
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._fenced is not None:
            _synchronize(self._fenced)
            self._fenced = None
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        node = self._node
        node.duration_ms = dt_ms
        if exc_type is not None:
            node.error = exc_type.__name__
        st = _STATE
        if st.stack and st.stack[-1] is node:
            st.stack.pop()
        registry().histogram(self.name).observe(dt_ms)


Span = span  # CamelCase alias


def _synchronize(value: Any) -> None:
    """Waits for the CUDA devices that hold tensors in ``value``."""
    devices = set()
    stack = [value]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    for dev in devices:
        torch.cuda.synchronize(dev)


def observe_ms(name: str, dt_s: float) -> None:
    """Record an already-measured duration (seconds) into histogram
    ``name`` — for call sites that time across yields (generators) where
    a context manager can't bracket the work."""
    registry().histogram(name).observe(dt_s * 1e3)
