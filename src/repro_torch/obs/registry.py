"""Unified metrics registry (a copy of the reference's ``obs/registry.py``;
numpy only).

Components (the session, and the executor and serving layers once they
are ported) own a :class:`MetricSet` of named counters, gauges, and
latency histograms, and the registry aggregates across every live
instance, so ``repro_torch.obs.summary()`` is the one place the
caching/sync/latency story of a whole process can be read, and
``repro_torch.obs.export_jsonl()`` emits the same numbers under the
reference's schema (``repro.obs/v1``).

Metric kinds and their cross-instance merge semantics:

* **counter** — monotonic float/int total; merged by SUM.
* **gauge**   — last-written value; merged by most-recent write.
* **histogram** — streaming latency/size distribution: exact count / sum /
  min / max plus a bounded reservoir of recent samples from which p50 /
  p95 / p99 are computed on demand; merged by combining the exact moments
  and concatenating (capped) reservoirs.

The registry keeps strong references to a bounded number of recent
MetricSets; older sets are *folded* into a retired aggregate on eviction,
so totals survive instance churn (tests build hundreds of executors)
without pinning instances or growing without bound.
"""
from __future__ import annotations

import collections
import json
import threading
import time

import numpy as np

_RESERVOIR_MAX = 2048
_LIVE_SETS_MAX = 512

_PERCENTILES = (50.0, 95.0, 99.0)


class Counter:
    """Monotonic total. ``inc`` returns the new value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> float:
        self.value += v
        return self.value

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value}


class Gauge:
    """Last-written value (cache sizes, boosts, current occupancy)."""

    __slots__ = ("value", "tick")

    def __init__(self):
        self.value = 0.0
        self.tick = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.tick = time.monotonic()

    def snapshot(self) -> dict:
        return {"kind": "gauge", "value": self.value, "tick": self.tick}


class Histogram:
    """Streaming distribution: exact moments + bounded sample reservoir.

    ``percentiles()`` (p50/p95/p99 by default) are computed from the
    reservoir of the most recent ``_RESERVOIR_MAX`` samples — exact for
    short runs, recency-weighted for long ones, which is the right bias
    for latency monitoring.
    """

    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: collections.deque = collections.deque(
            maxlen=_RESERVOIR_MAX)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.samples.append(v)

    def percentiles(self, qs=_PERCENTILES) -> dict:
        if not self.samples:
            return {f"p{q:g}": 0.0 for q in qs}
        arr = np.asarray(self.samples, np.float64)
        vals = np.percentile(arr, qs)
        return {f"p{q:g}": float(v) for q, v in zip(qs, vals)}

    def snapshot(self) -> dict:
        out = {"kind": "histogram", "count": self.count, "sum": self.total,
               "min": self.vmin if self.count else 0.0,
               "max": self.vmax if self.count else 0.0}
        out.update(self.percentiles())
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricSet:
    """One component instance's named metrics (owned by the instance,
    registered with the process registry for aggregation).

    The accessors are get-or-create, so recording a metric is one line at
    the call site: ``ms.count("queries")``, ``ms.observe("query_s", dt)``,
    ``ms.gauge("cache_entries", n)``.
    """

    __slots__ = ("component", "_metrics", "_lock")

    def __init__(self, component: str):
        self.component = component
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, _KINDS[kind]())
        return m

    # -- recording ----------------------------------------------------------

    def count(self, name: str, v: float = 1.0) -> float:
        return self._get("counter", name).inc(v)

    def gauge(self, name: str, v: float) -> None:
        self._get("gauge", name).set(v)

    def observe(self, name: str, v: float) -> None:
        self._get("histogram", name).observe(v)

    # -- reading ------------------------------------------------------------

    def counter_value(self, name: str) -> float:
        m = self._metrics.get(name)
        return float(m.value) if isinstance(m, Counter) else 0.0

    def counters(self) -> dict:
        """{name: int-or-float total} over the counter metrics only —
        the drop-in replacement for the legacy ``collections.Counter``
        totals the old ``stats()`` dicts were built from."""
        out = {}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                v = m.value
                out[name] = int(v) if float(v).is_integer() else v
        return out

    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in
                sorted(self._metrics.items())}


def _merge(into: dict, frm: dict) -> None:
    """Merge one snapshot dict into an aggregate (per-kind semantics)."""
    for name, snap in frm.items():
        cur = into.get(name)
        if cur is None:
            into[name] = dict(snap)
            if snap["kind"] == "histogram":
                into[name] = dict(snap)
            continue
        kind = snap["kind"]
        if kind == "counter":
            cur["value"] += snap["value"]
        elif kind == "gauge":
            if snap.get("tick", 0.0) >= cur.get("tick", 0.0):
                cur.update(snap)
        elif kind == "histogram":
            n0, n1 = cur["count"], snap["count"]
            if n1 == 0:
                continue
            if n0 == 0:
                cur.update(snap)
                continue
            cur["count"] = n0 + n1
            cur["sum"] += snap["sum"]
            cur["min"] = min(cur["min"], snap["min"])
            cur["max"] = max(cur["max"], snap["max"])
            # percentile fields: count-weighted blend — approximate, but
            # the registry aggregate is for the summary table; per-set
            # snapshots keep the exact reservoir quantiles
            for q in _PERCENTILES:
                key = f"p{q:g}"
                cur[key] = (cur[key] * n0 + snap[key] * n1) / (n0 + n1)


class Registry:
    """Process-wide aggregation point over every component MetricSet."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: collections.OrderedDict = collections.OrderedDict()
        self._retired: dict = {}            # component -> merged snapshot
        self._seq = 0

    # -- membership ---------------------------------------------------------

    def metric_set(self, component: str) -> MetricSet:
        """Create and register a new instance-scoped MetricSet."""
        ms = MetricSet(component)
        with self._lock:
            self._seq += 1
            self._live[self._seq] = ms
            while len(self._live) > _LIVE_SETS_MAX:
                _k, old = self._live.popitem(last=False)
                _merge(self._retired.setdefault(old.component, {}),
                       old.snapshot())
        return ms

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._retired.clear()

    # -- reading ------------------------------------------------------------

    def aggregate(self) -> dict:
        """{component: {metric: merged snapshot}} over live + retired."""
        out: dict = {}
        with self._lock:
            for comp, snap in self._retired.items():
                _merge(out.setdefault(comp, {}), snap)
            for ms in self._live.values():
                _merge(out.setdefault(ms.component, {}), ms.snapshot())
        return out

    def metrics_dict(self) -> dict:
        """The unified metric schema: a flat list of metric records,
        each ``{component, name, kind, ...values}`` — the shape both
        ``export_jsonl`` and the benchmark tooling consume."""
        rows = []
        for comp, metrics in sorted(self.aggregate().items()):
            for name, snap in sorted(metrics.items()):
                rows.append({"component": comp, "name": name, **snap})
        return {"schema": "repro.obs/v1", "metrics": rows}

    def summary(self) -> str:
        """Human-readable table of the unified registry (the replacement
        for eyeballing N different stats() dicts)."""
        agg = self.aggregate()
        lines = ["# repro.obs summary",
                 f"# {'component':<18}{'metric':<34}{'value':>14}"
                 f"{'p50':>10}{'p95':>10}{'p99':>10}{'n':>8}"]
        if not agg:
            lines.append("# (no metrics recorded)")
        for comp, metrics in sorted(agg.items()):
            for name, snap in sorted(metrics.items()):
                if snap["kind"] == "histogram":
                    scale, unit = ((1e6, "_us") if name.endswith("_s")
                                   else (1.0, ""))
                    disp = name[:-2] + unit if unit else name
                    lines.append(
                        f"# {comp:<18}{disp:<34}{'':>14}"
                        f"{snap['p50'] * scale:>10.1f}"
                        f"{snap['p95'] * scale:>10.1f}"
                        f"{snap['p99'] * scale:>10.1f}"
                        f"{snap['count']:>8d}")
                else:
                    v = snap["value"]
                    vs = f"{v:.0f}" if float(v).is_integer() else f"{v:.4g}"
                    lines.append(f"# {comp:<18}{name:<34}{vs:>14}"
                                 f"{'':>10}{'':>10}{'':>10}{'':>8}")
        return "\n".join(lines)

    def export_metrics_jsonl(self, fh) -> int:
        """Write one JSONL line per aggregated metric; returns the line
        count."""
        payload = self.metrics_dict()
        n = 0
        for row in payload["metrics"]:
            fh.write(json.dumps({"type": "metric", **row},
                                sort_keys=True) + "\n")
            n += 1
        return n


REGISTRY = Registry()
