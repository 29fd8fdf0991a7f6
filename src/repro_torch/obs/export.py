"""Exporters: Prometheus text exposition and JSON snapshot.

``render_prometheus`` emits the text format scrapers expect: counters as
``hmgi_<name>_total``, gauges bare, histograms as cumulative
``_bucket{le="..."}`` series plus ``_sum``/``_count``. Metric names are
sanitised (dots and dashes become underscores) and prefixed ``hmgi_``.
``parse_prometheus`` is the inverse over our own output — it exists for
the exposition round-trip test, not as a general parser.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from .metrics import MetricsRegistry, registry


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return "hmgi_" + "".join(out)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def render_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition of the registry (default: the global
    one). Stable ordering (sorted by name) so output diffs cleanly."""
    reg = reg or registry()
    lines = []
    for name, c in sorted(reg.counters().items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m}_total counter")
        lines.append(f"{m}_total {_fmt(c.value)}")
    for name, g in sorted(reg.gauges().items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(g.value)}")
    for name, h in sorted(reg.histograms().items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} histogram")
        for le, cum in h.cumulative_buckets():
            lines.append(f'{m}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f"{m}_sum {_fmt(h.total)}")
        lines.append(f"{m}_count {h.count}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[str, object]]:
    """Parse our own exposition back into
    ``{counters: {m: v}, gauges: {m: v}, histograms: {m: {buckets:
    [(le, cum)], sum, count}}}`` keyed by sanitised metric name. Used by
    the round-trip test."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, object]] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, metric, kind = line.split()
            types[metric] = kind
            continue
        if line.startswith("#"):
            continue
        key, sval = line.rsplit(" ", 1)
        val = float(sval.replace("+Inf", "inf"))
        if "{" in key:
            base, label = key.split("{", 1)
            assert base.endswith("_bucket"), line
            m = base[: -len("_bucket")]
            le = float(label.split('"')[1].replace("+Inf", "inf"))
            hists.setdefault(m, {"buckets": [], "sum": 0.0, "count": 0})
            hists[m]["buckets"].append((le, int(val)))  # type: ignore[union-attr]
        elif key.endswith("_sum") and types.get(key[: -len("_sum")]) == "histogram":
            hists.setdefault(key[: -4], {"buckets": [], "sum": 0.0, "count": 0})
            hists[key[: -4]]["sum"] = val
        elif key.endswith("_count") and types.get(key[: -len("_count")]) == "histogram":
            hists.setdefault(key[: -6], {"buckets": [], "sum": 0.0, "count": 0})
            hists[key[: -6]]["count"] = int(val)
        elif key.endswith("_total") and types.get(key) == "counter":
            counters[key[: -6]] = val
        else:
            gauges[key] = val
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def buckets_from_histogram(h) -> Tuple[Tuple[float, int], ...]:
    return tuple(h.cumulative_buckets())
