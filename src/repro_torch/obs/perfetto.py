"""Perfetto / Chrome ``trace_event`` exporter (the reference's
``obs/perfetto.py``; pure Python).

Converts the host span ring into the Trace Event JSON format that
``ui.perfetto.dev`` and ``chrome://tracing`` open directly, so a traced
serve run can be inspected beside a ``torch.profiler`` trace
(``export_chrome_trace``) of the same run. Each span becomes one
complete event (``"ph": "X"``) with:

* ``ts``/``dur`` in microseconds on the span's ``perf_counter`` clock
  (``t0_s`` — relative placement is exact, absolute epoch is not);
* ``tid`` = the recording thread (so the submit thread, pump thread and
  caller threads land on separate tracks);
* ``args`` = the span's path, trace id (request-scoped spans) or
  ``trace_ids`` (batch-granular spans), and every recorded attribute —
  Perfetto's query/filter UI works over these.

Pure host-side post-processing over ``recent_spans()``; exporting never
touches device programs.
"""
from __future__ import annotations

import json
import os

from . import tracing


def to_trace_events(spans: list | None = None) -> dict:
    """Build the ``{"traceEvents": [...]}`` document (no file I/O)."""
    events = []
    pid = os.getpid()
    for rec in (tracing.recent_spans() if spans is None else spans):
        if rec.get("type", "span") != "span":
            continue
        args = {"path": rec.get("path", rec.get("name", ""))}
        if "trace" in rec:
            args["trace"] = rec["trace"]
        for k, v in (rec.get("attrs") or {}).items():
            args[k] = v
        events.append({
            "name": rec.get("name", "span"),
            "cat": "repro",
            "ph": "X",
            "ts": rec.get("t0_s", 0.0) * 1e6,
            "dur": rec.get("dur_s", 0.0) * 1e6,
            "pid": pid,
            "tid": rec.get("tid", 0),
            "args": args,
        })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_perfetto(path: str | None = None,
                    spans: list | None = None) -> str:
    """Write the span ring (or an explicit span list) as Trace Event
    JSON; returns the path written (default ``repro_perfetto.json``)."""
    out = path or "repro_perfetto.json"
    with open(out, "w") as fh:
        json.dump(to_trace_events(spans), fh)
    return out
