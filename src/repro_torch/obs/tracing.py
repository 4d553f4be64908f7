"""Span tracing (the reference's ``obs/tracing.py`` on PyTorch).

``span(name, **attrs)`` is a nestable context manager that measures a
host-side stage and, always, independent of any knob, enters a
``torch.profiler.record_function`` so the same stage shows up in a
``torch.profiler`` trace beside the kernels it launched. Host-side
*recording* is gated by the ``REPRO_TRACE`` env knob:

* unset / ``0`` / ``off``  — spans are timed-and-dropped (near-zero cost);
* ``1`` / ``log``          — spans are kept in an in-memory ring buffer
  (``recent_spans()``) and logged at DEBUG;
* ``2`` / ``jsonl`` / a path ending in ``.jsonl`` — spans additionally
  stream to a JSONL file (default ``repro_trace.jsonl``, overridable via
  ``REPRO_TRACE_PATH`` or by giving the path as the knob value itself).

Span taxonomy (fixed, so dashboards and tests can rely on the names):
top-level ``query`` and ``step`` (sessions); children ``plan``,
``compile``, ``launch``, ``sync``. Nesting is tracked per-thread; a span
record carries its slash-joined path (``step/launch``), its start time
``t0_s`` (``time.perf_counter`` clock), and the recording thread's
``tid``.

**Trace context**: ``with trace_scope("req-000042"): ...`` pins a
per-thread request id; every span recorded inside the scope (or given an
explicit ``trace=...`` attribute) carries it as the top-level ``trace``
field, and batch-granular spans carry the ``trace_ids`` list attribute
instead. ``timeline(trace_id)`` filters the ring down to one request's
spans in start-time order.

Nothing here changes what runs on the device: only host bookkeeping
differs with tracing on or off.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

from torch.profiler import record_function

logger = logging.getLogger("repro_torch.obs")

_RING_MAX = 10_000

_state_lock = threading.Lock()
_mode = "off"                   # "off" | "log" | "jsonl"
_path = "repro_trace.jsonl"
_fh = None                      # lazily-opened JSONL handle
_ring: collections.deque = collections.deque(maxlen=_RING_MAX)
_seq = 0

_tls = threading.local()


def _parse_knob(val: str | None) -> tuple[str, str | None]:
    """REPRO_TRACE value -> (mode, path-or-None)."""
    v = (val or "").strip()
    if v.lower() in ("", "0", "off", "false", "no"):
        return "off", None
    if v.lower() in ("1", "log", "on", "true", "yes"):
        return "log", None
    if v.lower() in ("2", "jsonl"):
        return "jsonl", None
    if v.endswith(".jsonl"):
        return "jsonl", v
    return "log", None


def configure(mode: str | None = None, path: str | None = None) -> None:
    """Set the trace mode/path at runtime (tests, benchmarks). With no
    arguments, re-reads ``REPRO_TRACE`` / ``REPRO_TRACE_PATH`` from the
    environment."""
    global _mode, _path, _fh
    with _state_lock:
        if mode is None:
            mode, knob_path = _parse_knob(os.environ.get("REPRO_TRACE"))
            path = path or os.environ.get("REPRO_TRACE_PATH") or knob_path
        if mode not in ("off", "log", "jsonl"):
            raise ValueError(f"unknown trace mode: {mode!r}")
        if _fh is not None:
            _fh.close()
            _fh = None
        _mode = mode
        if path:
            _path = path


def trace_enabled() -> bool:
    return _mode != "off"


def trace_mode() -> str:
    return _mode


def trace_path() -> str:
    return _path


def reset() -> None:
    """Drop buffered spans (tests). Does not change mode/path."""
    global _seq
    with _state_lock:
        _ring.clear()
        _seq = 0


def recent_spans() -> list:
    """Recorded span dicts, oldest first (in-memory ring buffer)."""
    with _state_lock:
        return list(_ring)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _trace_stack() -> list:
    st = getattr(_tls, "trace", None)
    if st is None:
        st = _tls.trace = []
    return st


def current_trace() -> str | None:
    """The innermost trace id pinned on this thread (None outside any
    ``trace_scope``)."""
    st = _trace_stack()
    return st[-1] if st else None


class trace_scope:
    """``with trace_scope("req-000042"): ...`` — every span recorded on
    this thread inside the block carries ``trace: "req-000042"``."""

    __slots__ = ("trace_id",)

    def __init__(self, trace_id: str):
        self.trace_id = trace_id

    def __enter__(self):
        _trace_stack().append(self.trace_id)
        return self.trace_id

    def __exit__(self, *exc):
        st = _trace_stack()
        if st and st[-1] == self.trace_id:
            st.pop()
        return False


def _clean_attr(v):
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_clean_attr(x) for x in v]
    return str(v)


def _emit(rec: dict) -> None:
    global _fh, _seq
    with _state_lock:
        _seq += 1
        rec["seq"] = _seq
        _ring.append(rec)
        if _mode == "jsonl":
            if _fh is None:
                _fh = open(_path, "a", buffering=1)
            _fh.write(json.dumps(rec, sort_keys=True) + "\n")
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("span %s %.1fus", rec["path"], rec["dur_s"] * 1e6)


def record_span(name: str, dur_s: float, *, t0_s: float | None = None,
                **attrs) -> None:
    """Record a span retroactively (for stages detected after the fact,
    e.g. a kernel build identified after the launch call returned).
    Nested under the current thread's open span, if any. ``t0_s`` is the
    start on the ``perf_counter`` clock (defaults to now-minus-duration);
    a ``trace=...`` attribute (or an enclosing ``trace_scope``) is hoisted
    to the record's top-level ``trace``."""
    if _mode == "off":
        return
    st = _stack()
    path = "/".join(st + [name])
    trace = attrs.pop("trace", None) or current_trace()
    rec = {"type": "span", "name": name, "path": path, "dur_s": dur_s,
           "t0_s": (time.perf_counter() - dur_s if t0_s is None
                    else float(t0_s)),
           "tid": threading.get_ident()}
    if trace is not None:
        rec["trace"] = trace
    if attrs:
        rec["attrs"] = {k: _clean_attr(v) for k, v in attrs.items()}
    _emit(rec)


class span:
    """``with span("plan", nq=1024) as sp: ...`` — times the block, tags
    it in the profiler trace, records it per REPRO_TRACE. ``sp.duration`` is
    available after exit; ``sp.set(**attrs)`` adds attributes mid-flight."""

    __slots__ = ("name", "attrs", "duration", "_t0", "_ann", "_path")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.duration = 0.0
        self._t0 = 0.0
        self._ann = None
        self._path = name

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        self._path = "/".join(st + [self.name])
        st.append(self.name)
        # always annotate: profiler visibility must not depend on the
        # host-recording knob, and record_function is cheap when no
        # profiler is active
        self._ann = record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self._t0
        self._ann.__exit__(*exc)
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        if _mode != "off":
            trace = self.attrs.pop("trace", None) or current_trace()
            rec = {"type": "span", "name": self.name, "path": self._path,
                   "dur_s": self.duration, "t0_s": self._t0,
                   "tid": threading.get_ident()}
            if trace is not None:
                rec["trace"] = trace
            if self.attrs:
                rec["attrs"] = {k: _clean_attr(v)
                                for k, v in self.attrs.items()}
            _emit(rec)
        return False


def timeline(trace_id: str, spans: list | None = None) -> list:
    """One request's spans in start-time order: every span whose
    top-level ``trace`` matches, plus batch-granular spans whose
    ``trace_ids`` attribute contains the id. The per-request
    reconstruction the serving acceptance test asserts covers
    admission through resolution."""
    out = []
    for rec in (recent_spans() if spans is None else spans):
        if rec.get("type", "span") != "span":
            continue
        if rec.get("trace") == trace_id:
            out.append(rec)
        else:
            ids = (rec.get("attrs") or {}).get("trace_ids")
            if ids and trace_id in ids:
                out.append(rec)
    out.sort(key=lambda r: (r.get("t0_s", 0.0), r.get("seq", 0)))
    return out


def export_jsonl(path: str | None = None, registry=None) -> str:
    """Dump buffered spans plus the aggregated metric registry as JSONL.

    One ``{"type": "span", ...}`` line per buffered span and one
    ``{"type": "metric", ...}`` line per aggregated metric. Returns the
    path written."""
    from .registry import REGISTRY
    reg = registry if registry is not None else REGISTRY
    out = path or _path
    with open(out, "a", buffering=1) as fh:
        for rec in recent_spans():
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
        reg.export_metrics_jsonl(fh)
    return out


# pick up the env knob at import so `REPRO_TRACE=1 pytest` just works
configure()
