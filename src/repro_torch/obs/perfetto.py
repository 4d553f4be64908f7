"""Perfetto / Chrome ``trace_event`` exporter (the reference's
``obs/perfetto.py``; pure Python).

Converts the host span ring into the Trace Event JSON format that
``ui.perfetto.dev`` and ``chrome://tracing`` open directly. Each span
becomes one complete event (``"ph": "X"``) with:

* ``ts``/``dur`` in microseconds, ``ts`` on the clock that
  ``torch.profiler`` stamps host and device events with (the Unix epoch):
  the span's ``perf_counter`` start ``t0_s`` plus an offset sampled at
  export (``tracing.profiler_clock_offset_ns``);
* ``tid`` = the recording thread (so the submit thread, pump thread and
  caller threads land on separate tracks);
* ``args`` = the span's path, trace id (request-scoped spans) or
  ``trace_ids`` (batch-granular spans), and every recorded attribute —
  Perfetto's query/filter UI works over these.

Given a finished ``torch.profiler.profile`` (``profile=prof``), the same
document also holds the profiler's own events: host operations under this
process, device kernels and copies under one process a card (``pid`` =
the card's index, ``tid`` = the stream; a ``record_function``'s range on
the card is ``gpu_user_annotation``). A device idle gap then lies on one
timeline with the host span open during it.

Pure host-side post-processing; exporting never touches device programs.
"""
from __future__ import annotations

import json
import os

from . import tracing


def _profile_events(prof) -> list:
    """The complete events of a finished ``torch.profiler.profile``, read
    from its raw results, with a ``process_name`` event for each card."""
    from torch.autograd import DeviceType
    events, cards = [], set()
    for e in prof.profiler.kineto_results.events():
        on_host = e.device_type() == DeviceType.CPU
        if not on_host:
            cards.add(e.device_index())
        if e.is_user_annotation():
            cat = "user_annotation" if on_host else "gpu_user_annotation"
        else:
            cat = "cpu_op" if on_host else "device"
        events.append({
            "name": e.name(),
            "cat": cat,
            "ph": "X",
            "ts": e.start_ns() / 1e3,
            "dur": e.duration_ns() / 1e3,
            "pid": os.getpid() if on_host else e.device_index(),
            "tid": e.device_resource_id(),
        })
    for card in sorted(cards):
        events.append({"name": "process_name", "ph": "M", "pid": card,
                       "args": {"name": f"cuda:{card}"}})
    return events


def to_trace_events(spans: list | None = None, profile=None) -> dict:
    """Build the ``{"traceEvents": [...]}`` document (no file I/O): the
    spans (default the ring) and, with ``profile``, a finished profiler's
    events, on one clock."""
    events = []
    pid = os.getpid()
    offset_us = tracing.profiler_clock_offset_ns() / 1e3
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
            "ts": rec.get("t0_s", 0.0) * 1e6 + offset_us,
            "dur": rec.get("dur_s", 0.0) * 1e6,
            "pid": pid,
            "tid": rec.get("tid", 0),
            "args": args,
        })
    if profile is not None:
        events += _profile_events(profile)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_perfetto(path: str | None = None, spans: list | None = None,
                    profile=None) -> str:
    """Write the span ring (or an explicit span list), and a finished
    profiler's events if given, as Trace Event JSON; returns the path
    written (default ``repro_perfetto.json``)."""
    out = path or "repro_perfetto.json"
    with open(out, "w") as fh:
        json.dump(to_trace_events(spans, profile), fh)
    return out
