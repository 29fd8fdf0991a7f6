"""Named crash points at every durability boundary (fault injection): the
port's copy of the reference's ``repro.persistence.faultpoints`` (same
points, the same ``HMGI_FAULTPOINT`` variable, the same modes).

Durability claims are only as good as the crashes they survive. Every place
where the persistence layer transitions between "not yet durable" and
"durable" — around a log append, between snapshot leaf writes, around the
atomic rename, between replayed records — calls ``crash_point(name)``. In
production the call is a no-op (one dict lookup). Under test, a point is
*armed* and the process dies there mid-operation, exactly like ``kill -9``:

    HMGI_FAULTPOINT=wal.post_append      python child.py   # die on 1st hit
    HMGI_FAULTPOINT=wal.post_append:3    python child.py   # die on 3rd hit

or programmatically: ``faultpoints.arm("snapshot.pre_rename", hits=2)``.
The default crash mode is ``os._exit(137)`` — no atexit handlers, no
buffered-write flushing, nothing the real SIGKILL wouldn't do. Unit tests
that want to observe the failure in-process can arm with ``mode="raise"``,
which raises ``FaultInjected`` instead.

``POINTS`` is the static registry the sweep tests iterate: *every* entry
must be survivable — killing the process there and running ``recover()``
must yield search results bit-identical to an uninterrupted run of the
durable op prefix (``repro_torch.persistence.crash_harness`` asserts this
for each one).
``crash_point`` refuses names outside the registry, so a new durability
boundary cannot be added without also entering the sweep.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# the sweep surface: one name per durability boundary (each point's
# durable-prefix contract: docs/DESIGN.md §7.4)
POINTS = (
    "wal.pre_append",       # before the record's bytes reach the segment
    "wal.post_append",      # after write (+fsync when the batch synced)
    "wal.pre_rotate",       # before a new segment file is created
    "wal.pre_gc",           # after a snapshot, before old segments unlink
    "wal.post_gc",          # after old segments unlink + dir fsync
    "snapshot.mid_write",   # between leaf files inside the .tmp dir
    "snapshot.pre_rename",  # .tmp complete + fsync'd, not yet visible
    "snapshot.post_rename", # renamed, parent dir not yet fsync'd
    "recover.mid_replay",   # between replayed op records
)

_ENV = "HMGI_FAULTPOINT"


class FaultInjected(RuntimeError):
    """Raised instead of killing the process when armed with mode="raise"."""

    def __init__(self, name: str):
        super().__init__(f"fault injected at {name}")
        self.point = name


class _Armed:
    def __init__(self, name: str, hits: int, mode: str):
        self.name = name
        self.remaining = hits
        self.mode = mode


_armed: Optional[_Armed] = None
_env_parsed = False
hit_counts: Dict[str, int] = {}


def arm(name: str, hits: int = 1, mode: str = "exit") -> None:
    """Arms ``name``: the ``hits``-th call to ``crash_point(name)`` crashes
    (mode="exit": ``os._exit(137)``; mode="raise": ``FaultInjected``)."""
    global _armed, _env_parsed
    if name not in POINTS:
        raise ValueError(f"unknown fault point {name!r} (register in POINTS)")
    if mode not in ("exit", "raise"):
        raise ValueError(f"unknown fault mode {mode!r}")
    _armed = _Armed(name, int(hits), mode)
    _env_parsed = True          # programmatic arming overrides the env


def disarm() -> None:
    global _armed, _env_parsed
    _armed = None
    _env_parsed = True
    hit_counts.clear()


def _parse_env() -> None:
    global _env_parsed, _armed
    _env_parsed = True
    spec = os.environ.get(_ENV, "")
    if not spec:
        return
    name, _, hits = spec.partition(":")
    arm(name.strip(), int(hits) if hits else 1, mode="exit")


def crash_point(name: str) -> None:
    """A durability boundary. No-op unless this point is armed."""
    if name not in POINTS:
        raise ValueError(f"unregistered fault point {name!r} — add to POINTS")
    if not _env_parsed:
        _parse_env()
    hit_counts[name] = hit_counts.get(name, 0) + 1
    a = _armed
    if a is None or a.name != name:
        return
    a.remaining -= 1
    if a.remaining > 0:
        return
    if a.mode == "raise":
        disarm()
        raise FaultInjected(name)
    os._exit(137)               # the real thing: no flush, no cleanup
