"""The index core: quantization, partitioning, IVF, delta, graph, fusion, facade.

``HMGIIndex``, ``ModalityIndex`` and ``NodeAttributes`` are exported as in
the reference (``from repro_torch.core import HMGIIndex``), loaded on first
access: the facade imports this package's submodules, and the query engine
(which the facade calls) imports them too, so an eager import here would
load the facade before the submodules it needs.
"""
_EXPORTS = {"HMGIIndex": "repro_torch.core.index",
            "ModalityIndex": "repro_torch.core.index",
            "NodeAttributes": "repro_torch.core.graph_store"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
