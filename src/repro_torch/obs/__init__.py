"""Unified observability layer: metrics registry, trace spans, exporters.

The port's own copy of the reference's framework-free ``repro.obs``.
Host-side only. See ``metrics`` (counters/gauges/histograms with exact
quantiles), ``spans`` (nestable timed spans with optional CUDA
synchronisation at exit and a ``trace()`` tree collector), and ``export``
(Prometheus text exposition, JSON snapshot). The serving modules and the
``HMGIIndex`` facade record into it (``trace=True``, ``metrics()["obs"]``).

Typical use::

    from repro_torch import obs

    obs.counter("serving.admitted").inc()
    with obs.span("query.seed_scan") as sp:
        sv, si = run_seed(...)
        sp.fence((sv, si))           # synced only if cfg.obs_sync_spans

    print(obs.render_prometheus())
"""
from .metrics import (COUNT_BUCKETS, DEFAULT_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, enabled, registry,
                      set_enabled)
from .spans import (Span, SpanNode, Trace, observe_ms, set_sync_spans, span,
                    sync_spans, trace)
from .export import parse_prometheus, render_prometheus


def counter(name: str) -> Counter:
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return registry().histogram(name, buckets)


def snapshot() -> dict:
    """JSON-able snapshot of the global registry."""
    return registry().to_dict()


def reset() -> None:
    """Drop every metric in the global registry (tests, bench phases)."""
    registry().reset()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "COUNT_BUCKETS",
    "registry", "counter", "gauge", "histogram", "snapshot", "reset",
    "enabled", "set_enabled",
    "Span", "SpanNode", "Trace", "span", "trace", "observe_ms",
    "set_sync_spans", "sync_spans",
    "render_prometheus", "parse_prometheus",
]
