"""OpenMetrics text exporter (a copy of the reference's
``obs/openmetrics.py``; pure Python).

Renders the aggregated metric registry — and the per-tenant SLO board —
in the OpenMetrics text exposition format, so the whole process scrapes
like a Prometheus target (pipe ``obs.export_openmetrics()`` to a file or
an HTTP handler; no server is bundled).

Mapping from the registry's metric kinds:

* **counter**   → ``counter`` family; sample name gets the mandatory
  ``_total`` suffix.
* **gauge**     → ``gauge`` family (the ``tick`` bookkeeping field is
  dropped — it is merge metadata, not a measurement).
* **histogram** → ``summary`` family: ``quantile``-labelled samples for
  p50/p95/p99 plus ``_sum`` and ``_count`` (the registry keeps a
  reservoir, not fixed buckets, so a summary is the honest rendering).

The kernels' device counters (``kernel_counters``) render as ``counter``
families ``repro_kernel_{kernel}_{count}``, one sample a launch signature
(``window``, ``sphere_test`` and ``boxed`` labels), and ``..._query_rows``
and ``..._boxed_rows``.

Metric names are ``repro_{component}_{name}`` with every
non-``[a-zA-Z0-9_]`` character collapsed to ``_``. Per-tenant SLO
families (``repro_slo_*``) carry a ``tenant`` label. Output ends with
the mandatory ``# EOF`` terminator; tests/test_torch_obs_serve.py
validates the grammar line-by-line.
"""
from __future__ import annotations

import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_ESC = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


def _metric_name(component: str, name: str) -> str:
    base = _NAME_RE.sub("_", f"repro_{component}_{name}")
    if base[0].isdigit():
        base = "_" + base
    return base


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return f"{int(f)}" if f.is_integer() else repr(f)


def _label(k: str, v: str) -> str:
    return f'{k}="{str(v).translate(_LABEL_ESC)}"'


def _emit_family(lines: list, fam: str, omtype: str,
                 samples: list) -> None:
    """samples: [(sample_name, label_str_or_empty, value)]."""
    lines.append(f"# TYPE {fam} {omtype}")
    for sname, labels, value in samples:
        lines.append(f"{sname}{labels} {_fmt(value)}")


def _signature_labels(sig: dict) -> str:
    """A launch signature's labels: ``window="7x7x7"`` (``other`` for the
    counter's overflow rows), ``sphere_test`` and ``boxed``."""
    window = "x".join(map(str, sig["window"])) if sig["window"] else "other"
    return ("{" + _label("window", window) + ","
            + _label("sphere_test", str(sig["sphere_test"]).lower()) + ","
            + _label("boxed", str(sig["boxed"]).lower()) + "}")


def export_openmetrics(registry=None, board=None) -> str:
    """The full OpenMetrics text exposition (a ``str`` ending in
    ``# EOF``)."""
    from .registry import REGISTRY
    from . import slo as slo_mod
    reg = registry if registry is not None else REGISTRY
    brd = board if board is not None else slo_mod.BOARD

    lines: list = []
    for comp, metrics in sorted(reg.aggregate().items()):
        for name, snap in sorted(metrics.items()):
            fam = _metric_name(comp, name)
            kind = snap["kind"]
            if kind == "counter":
                _emit_family(lines, fam, "counter",
                             [(f"{fam}_total", "", snap["value"])])
            elif kind == "gauge":
                _emit_family(lines, fam, "gauge",
                             [(fam, "", snap["value"])])
            elif kind == "histogram":
                samples = [
                    (fam, "{" + _label("quantile", "0.5") + "}",
                     snap.get("p50", 0.0)),
                    (fam, "{" + _label("quantile", "0.95") + "}",
                     snap.get("p95", 0.0)),
                    (fam, "{" + _label("quantile", "0.99") + "}",
                     snap.get("p99", 0.0)),
                    (f"{fam}_sum", "", snap["sum"]),
                    (f"{fam}_count", "", snap["count"]),
                ]
                _emit_family(lines, fam, "summary", samples)

    snap = brd.snapshot()
    if snap:
        # one TYPE line per family, then every tenant's sample
        fams = [
            ("repro_slo_requests", "counter", "requests",
             lambda row: row["requests"]),
            ("repro_slo_attainment", "gauge", None,
             lambda row: row["attainment"]),
            ("repro_slo_burn_rate", "gauge", None,
             lambda row: row["burn_rate"]),
        ]
        for fam, omtype, _key, get in fams:
            sname = fam + ("_total" if omtype == "counter" else "")
            _emit_family(
                lines, fam, omtype,
                [(sname, "{" + _label("tenant", tenant) + "}", get(row))
                 for tenant, row in snap.items()])
        _emit_family(
            lines, "repro_slo_outcomes", "counter",
            [("repro_slo_outcomes_total",
              "{" + _label("tenant", tenant) + "," +
              _label("outcome", oc) + "}", n)
             for tenant, row in snap.items()
             for oc, n in sorted(row["outcomes"].items())])
        lat_samples = []
        for tenant, row in snap.items():
            lat = row["latency"]
            if not lat.get("count"):
                continue
            tl = _label("tenant", tenant)
            lat_samples += [
                ("repro_slo_latency_seconds",
                 "{" + tl + "," + _label("quantile", "0.5") + "}",
                 lat.get("p50", 0.0)),
                ("repro_slo_latency_seconds",
                 "{" + tl + "," + _label("quantile", "0.99") + "}",
                 lat.get("p99", 0.0)),
                ("repro_slo_latency_seconds_sum", "{" + tl + "}",
                 lat.get("sum", 0.0)),
                ("repro_slo_latency_seconds_count", "{" + tl + "}",
                 lat.get("count", 0)),
            ]
        if lat_samples:
            _emit_family(lines, "repro_slo_latency_seconds", "summary",
                         lat_samples)

    from .device import kernel_counters
    for kernel, counts in kernel_counters().items():
        for name, total in counts.items():
            if name == "by_signature":
                continue
            fam = _metric_name("kernel", f"{kernel}_{name}")
            samples = ([(f"{fam}_total", "", total)]
                       if name in ("query_rows", "boxed_rows") else
                       [(f"{fam}_total", _signature_labels(sig), sig[name])
                        for sig in counts["by_signature"]])
            _emit_family(lines, fam, "counter", samples)

    lines.append("# EOF")
    return "\n".join(lines) + "\n"
