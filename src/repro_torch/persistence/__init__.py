"""Durable index lifecycle: versioned snapshots + write-ahead op log +
crash recovery (docs/DESIGN.md §7), the port of ``repro.persistence``.

- ``faultpoints`` — named crash points at every durability boundary
- ``oplog`` — CRC-framed, segmented, fsync-batched append-only op log
- ``snapshot`` — full-HMGIIndex-state snapshots via the checkpoint substrate
- ``durable`` — ``DurableHMGIIndex`` (log-then-apply facade) + ``recover``
- ``crash_harness`` — the kill -9 sweep over every crash point

The files on disk are the reference's, byte for byte: either package reads
what the other wrote.

Import hygiene: ``repro_torch.checkpoint`` imports ``faultpoints`` from this
package, and ``durable`` imports ``repro_torch.checkpoint`` — so the package
``__init__`` re-exports lazily (PEP 562) to keep the import graph acyclic.
"""
from repro_torch.persistence import faultpoints  # noqa: F401  (dependency-free)

_LAZY = {
    "DurableHMGIIndex": "repro_torch.persistence.durable",
    "recover": "repro_torch.persistence.durable",
    "replay_op": "repro_torch.persistence.durable",
    "OpLog": "repro_torch.persistence.oplog",
    "config_fingerprint": "repro_torch.persistence.snapshot",
}

__all__ = ["faultpoints", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
