"""Flight recorder: bounded post-mortem state (a copy of the reference's
``obs/flight.py``; pure Python).

Telemetry answers "how is the system doing"; the flight recorder answers
"what was the system doing *in the seconds before it broke*". It keeps a
bounded in-memory ring of structured events the serving stack feeds
continuously — drain reports, breaker transitions, retries, degradation
decisions — and on a reliability failure path (breaker open, pump crash,
hung future, ``QueryError``) dumps a single post-mortem JSON combining:

* the event ring (most recent ``_EVENTS_MAX`` events),
* the tail of the span ring (``recent_spans()``, trace ids included),
* the full aggregated metric registry,
* the per-tenant SLO board snapshot.

Knobs: ``REPRO_FLIGHT`` (unset/0 = disabled — the
ring still records, dumps are suppressed), ``REPRO_FLIGHT_PATH`` (dump
path, default ``repro_flight.json``; an existing file is overwritten —
the *last* crash wins, like a real FDR).

The ring registers with ``obs.lifecycle.on_reset`` so back-to-back test
scenarios start clean; enablement/path are configuration and survive
``obs.reset()``.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from .lifecycle import on_reset
from . import tracing

_EVENTS_MAX = 512
_SPAN_TAIL = 2048       # spans included in a dump


def _parse_bool(val: str | None) -> bool:
    return (val or "").strip().lower() not in ("", "0", "off", "false", "no")


class FlightRecorder:
    """Bounded ring of recent serving events + one-shot post-mortem dump
    (one instance: ``RECORDER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=_EVENTS_MAX)
        self._enabled = _parse_bool(os.environ.get("REPRO_FLIGHT"))
        self._path = os.environ.get("REPRO_FLIGHT_PATH",
                                    "repro_flight.json")
        self._dumps = 0

    # -- configuration ------------------------------------------------------

    def configure(self, enabled: bool | None = None,
                  path: str | None = None) -> None:
        """Set enablement/path at runtime; with no arguments, re-reads
        ``REPRO_FLIGHT`` / ``REPRO_FLIGHT_PATH``."""
        with self._lock:
            if enabled is None and path is None:
                self._enabled = _parse_bool(os.environ.get("REPRO_FLIGHT"))
                self._path = os.environ.get("REPRO_FLIGHT_PATH",
                                            "repro_flight.json")
                return
            if enabled is not None:
                self._enabled = bool(enabled)
            if path is not None:
                self._path = path

    def enabled(self) -> bool:
        return self._enabled

    def path(self) -> str:
        return self._path

    # -- recording ----------------------------------------------------------

    def note(self, kind: str, **payload) -> None:
        """Append one structured event to the ring (always, even when
        dumping is disabled — enabling REPRO_FLIGHT mid-flight still
        yields history). Payload values must be JSON-encodable; anything
        exotic is stringified."""
        rec = {"t": time.time(), "kind": kind}
        for k, v in payload.items():
            if isinstance(v, (int, float, str, bool, type(None), list,
                              dict)):
                rec[k] = v
            else:
                rec[k] = str(v)
        with self._lock:
            self._events.append(rec)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def dump_count(self) -> int:
        with self._lock:
            return self._dumps

    # -- the post-mortem ----------------------------------------------------

    def dump(self, reason: str, path: str | None = None) -> str | None:
        """Write the post-mortem JSON; returns the path, or None when
        disabled (and no explicit ``path`` forces it). Never raises —
        a flight recorder that crashes the crashing service is useless;
        failures are recorded as an event and swallowed."""
        with self._lock:
            if not self._enabled and path is None:
                return None
            out = path or self._path
        try:
            from .registry import REGISTRY
            from . import slo
            doc = {
                "schema": "repro.obs/flight-v1",
                "reason": reason,
                "wall_time": time.time(),
                "pid": os.getpid(),
                "events": self.events(),
                "spans": tracing.recent_spans()[-_SPAN_TAIL:],
                "metrics": REGISTRY.metrics_dict(),
                "slo": slo.snapshot(),
            }
            tmp = out + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, sort_keys=True)
            os.replace(tmp, out)
            with self._lock:
                self._dumps += 1
            return out
        except Exception as exc:  # pragma: no cover - defensive
            self.note("flight_dump_failed", reason=reason, error=str(exc))
            return None

    def reset(self) -> None:
        """Clear the event ring and dump counter (registered with
        ``obs.lifecycle.on_reset``); enablement/path are configuration
        and survive."""
        with self._lock:
            self._events.clear()
            self._dumps = 0


RECORDER = FlightRecorder()
on_reset(RECORDER.reset)

# module-level conveniences (the service call sites)
configure = RECORDER.configure
enabled = RECORDER.enabled
note = RECORDER.note
events = RECORDER.events
dump = RECORDER.dump
dump_count = RECORDER.dump_count
