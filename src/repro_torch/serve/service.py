"""Multi-tenant streaming neighbor-query service (the reference's
``serve/service.py`` on PyTorch).

``NeighborService`` layers the serving contract over the functional core:

* ``submit(scene_id, queries, params)`` admits a request and returns a
  :class:`ServeFuture` resolved at drain time. Admission is bounded: past
  the ``max_pending`` high-water mark the queue **rejects with
  retry-after** (:class:`Rejected`) — or, with ``ServeOpts.degrade`` on,
  admits the request at a reduced ladder level and flags the response
  degraded (graceful degradation instead of rejection).
* ``pump()`` drains every *due* signature bucket (see ``batcher``) as one
  concatenated ``api.query`` against the scene variant's index — ONE
  blocking host sync per drained batch — with the next batch staged and
  dispatched while the previous one executes (``pipeline`` in-flight
  batches; the dispatch-then-stage overlap). On the card nothing between
  dispatch and sync synchronises: the upload is from pinned memory,
  ``api.query`` on the fused path makes no blocking transfer, and the end
  of each dispatch is marked by a ``torch.cuda.Event`` that the batch's
  sync waits for (a side stream that holds only a wait for the event is
  synchronised, so later batches keep running and
  ``torch.cuda.set_sync_debug_mode`` sees the one sync).
* ``drain()`` pumps with the deadline forced until the queue is empty.
* ``start()/stop()`` run the pump on a background thread for real
  streaming callers; the synchronous surface stays fully deterministic for
  tests and the trace launcher.

**Failure paths are first-class** (``repro_torch.reliability``). Every
admitted request resolves as exactly one of {result, ``QueryError``,
``DeadlineExceeded``, ``Rejected``, ``CircuitOpen``}
(plus ``Cancelled`` for caller-cancelled futures) — no future ever
hangs:

* inputs are validated at admission (``api.validate_queries``): NaN/inf/
  sentinel-colliding rows fail with a structured ``QueryError`` before
  they can poison a concatenated launch;
* per-request server-side deadlines: an expired request is dropped at
  bucket drain — BEFORE launch — and fails with ``DeadlineExceeded``
  (counted as ``serve.expired``); a caller-cancelled future is likewise
  dropped unlaunched, so a client that gave up cannot leak device work;
* transient launch failures retry with exponential backoff + jitter
  (bounded by ``ServeOpts.retries``);
* a per-scene **circuit breaker** (``reliability.breaker``) opens after
  ``breaker_n`` consecutive batch failures: the poisoned scene fails
  fast (``CircuitOpen`` at submit and drain) while every other tenant
  keeps draining; a half-open probe closes it once the scene recovers;
* the background pump thread is crash-contained: an escaped exception
  fails the in-flight futures, is counted (``serve.pump_restarts``),
  and the pump restarts instead of dying and hanging every future;
* every response carries :class:`~repro_torch.reliability.ResultQuality`
  derived from the scene's device overflow/oob counters
  (``fut.quality``), so silently-truncated neighborhoods are flagged.

Every stage feeds the unified telemetry layer (``repro_torch.obs``,
component ``serve``): queue-depth gauges, batch-occupancy histograms,
end-to-end request latency percentiles, per-drain straggler detection (the
shared ``train.fault_tolerance.StragglerMonitor``), and the host-sync
counter the one-sync contract is asserted against. ``obs.summary()`` over
a serving process reads as the service dashboard. Every request's spans,
``resolve`` included, are stamped on one clock (``time.perf_counter``), so
its timeline covers admission to resolution with no gap.

The service runs on the registry's device, the card unless the caller
passes ``device="cpu"``; the background pump thread selects that device
before it launches anything.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time

import numpy as np
import torch

from .. import obs
from ..obs import flight as flightrec
from ..obs import slo
from ..core import api
from ..core.executor import _wait
from ..core.types import SearchOpts, SearchParams, SearchResult
from ..reliability import faults
from ..reliability.breaker import CircuitBreaker
from ..reliability.errors import (Cancelled, CircuitOpen, DeadlineExceeded,
                                  QueryError, is_transient)
from ..reliability.quality import ResultQuality
from ..train.fault_tolerance import StragglerMonitor
from .batcher import BatchReport, MicroBatcher, Request, split_result, \
    stage_batch
from .registry import SceneRegistry


# request-scoped trace ids: process-unique across
# service instances, so merged span streams never collide
_REQ_IDS = itertools.count(1)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


class ServeOpts:
    """Service knobs (env defaults ``REPRO_SERVE_*`` / ``REPRO_DEADLINE_*``,
    the reference's knobs and defaults).

    ``max_pending``   admission high-water mark in pending *query rows*;
    ``max_batch``     max concatenated query rows per drained launch;
    ``max_wait_s``    bucket deadline — a request waits at most this long
                      before its bucket is due even if nearly empty
                      (``REPRO_SERVE_MAX_WAIT_MS`` is in milliseconds);
    ``pipeline``      in-flight launches the drain loop keeps before
                      syncing the oldest (0 = sync immediately after each
                      dispatch, i.e. no overlap);
    ``scenes``        registry capacity (resident scenes, LRU-evicted).

    Reliability:

    ``deadline_s``    default per-request server-side deadline
                      (``REPRO_DEADLINE_MS``; 0 = none — ``submit``'s
                      ``deadline_s`` overrides per request);
    ``retries``       bounded retry budget for transient launch failures;
    ``backoff_s``     base of the exponential backoff between retries
                      (jittered x0.5-1.5);
    ``breaker_n``     consecutive batch failures that open a scene's
                      circuit breaker;
    ``breaker_cooldown_s``  breaker cooldown before the half-open probe
                      (doubles on failed probes);
    ``retry_floor_s`` floor of the ``Rejected``/``CircuitOpen``
                      retry-after estimate (the cold-start hardening of
                      ``MicroBatcher._retry_after``);
    ``validate``      validate query inputs at admission
                      (``api.validate_queries`` -> ``QueryError``);
    ``degrade``       overload mode: past ``max_pending`` admit at the
                      reduced ``degrade_ladder`` (flagged degraded)
                      instead of rejecting, up to ``degrade_hard`` x
                      ``max_pending`` (past THAT, reject regardless);
    ``seed``          deterministic seed of the retry jitter.
    """

    __slots__ = ("max_pending", "max_batch", "max_wait_s", "pipeline",
                 "scenes", "deadline_s", "retries", "backoff_s",
                 "breaker_n", "breaker_cooldown_s", "retry_floor_s",
                 "validate", "degrade", "degrade_ladder", "degrade_hard",
                 "seed")

    def __init__(self, max_pending: int | None = None,
                 max_batch: int | None = None,
                 max_wait_s: float | None = None,
                 pipeline: int | None = None,
                 scenes: int | None = None,
                 deadline_s: float | None = None,
                 retries: int | None = None,
                 backoff_s: float | None = None,
                 breaker_n: int | None = None,
                 breaker_cooldown_s: float | None = None,
                 retry_floor_s: float | None = None,
                 validate: bool | None = None,
                 degrade: bool | None = None,
                 degrade_ladder: tuple = (1,),
                 degrade_hard: float = 2.0,
                 seed: int | None = None):
        self.max_pending = (_env_int("REPRO_SERVE_MAX_PENDING", 65536)
                            if max_pending is None else int(max_pending))
        self.max_batch = (_env_int("REPRO_SERVE_MAX_BATCH", 4096)
                          if max_batch is None else int(max_batch))
        self.max_wait_s = (
            _env_float("REPRO_SERVE_MAX_WAIT_MS", 2.0) / 1e3
            if max_wait_s is None else float(max_wait_s))
        self.pipeline = (_env_int("REPRO_SERVE_PIPELINE", 1)
                         if pipeline is None else int(pipeline))
        self.scenes = (_env_int("REPRO_SERVE_SCENES", 8)
                       if scenes is None else int(scenes))
        self.deadline_s = (_env_float("REPRO_DEADLINE_MS", 0.0) / 1e3
                           if deadline_s is None else float(deadline_s))
        self.retries = (_env_int("REPRO_SERVE_RETRIES", 2)
                        if retries is None else int(retries))
        self.backoff_s = (_env_float("REPRO_SERVE_BACKOFF_MS", 1.0) / 1e3
                          if backoff_s is None else float(backoff_s))
        self.breaker_n = (_env_int("REPRO_SERVE_BREAKER_N", 3)
                          if breaker_n is None else int(breaker_n))
        self.breaker_cooldown_s = (
            _env_float("REPRO_SERVE_BREAKER_COOLDOWN_MS", 50.0) / 1e3
            if breaker_cooldown_s is None else float(breaker_cooldown_s))
        self.retry_floor_s = (
            _env_float("REPRO_SERVE_RETRY_FLOOR_MS", 1.0) / 1e3
            if retry_floor_s is None else float(retry_floor_s))
        self.validate = (_env_int("REPRO_SERVE_VALIDATE", 1) != 0
                         if validate is None else bool(validate))
        self.degrade = (_env_int("REPRO_SERVE_DEGRADE", 0) != 0
                        if degrade is None else bool(degrade))
        self.degrade_ladder = tuple(int(w) for w in degrade_ladder)
        self.degrade_hard = float(degrade_hard)
        self.seed = (_env_int("REPRO_SERVE_SEED", 0)
                     if seed is None else int(seed))
        if self.max_batch < 1 or self.max_pending < 1:
            raise ValueError("max_batch and max_pending must be >= 1")
        if self.pipeline < 0:
            raise ValueError("pipeline must be >= 0")
        if self.retries < 0:
            raise ValueError("retries must be >= 0")
        if self.breaker_n < 1:
            raise ValueError("breaker_n must be >= 1")
        if self.degrade_hard < 1.0:
            raise ValueError("degrade_hard must be >= 1.0")


class Rejected(RuntimeError):
    """Admission refused past the high-water mark; retry after
    ``retry_after_s`` (an estimate from recent drain throughput)."""

    def __init__(self, pending: int, limit: int, retry_after_s: float):
        super().__init__(
            f"admission queue full ({pending} pending query rows >= "
            f"high-water {limit}); retry after ~{retry_after_s * 1e3:.1f}ms")
        self.retry_after_s = retry_after_s


class ServeFuture:
    """Result handle resolved when the request's batch drains.

    Resolution is **idempotent and single-shot**: the first
    ``set_result``/``set_exception`` wins and later ones are ignored, so
    a crash-containment path can never clobber an already-resolved
    future. ``cancel()`` lets a caller that gave up (e.g. after a
    ``result(timeout)`` timeout) withdraw the request: a cancelled
    request is dropped at bucket drain WITHOUT being launched (counted
    as ``serve.expired``), instead of leaking staged device work.

    ``quality`` carries the :class:`~repro_torch.reliability.ResultQuality`
    flags of a successful resolution (None until resolved / on error);
    ``trace_id`` the request-scoped trace context assigned at admission
    (``obs.timeline(fut.trace_id)`` is the request's span timeline).
    """

    __slots__ = ("_event", "_result", "_exc", "_cancelled", "_lock",
                 "request_id", "quality", "trace_id")

    def __init__(self, request_id: int, trace_id: str = ""):
        self.request_id = request_id
        self.trace_id = trace_id
        self._event = threading.Event()
        self._result: SearchResult | None = None
        self._exc: BaseException | None = None
        self._cancelled = False
        self._lock = threading.Lock()
        self.quality: ResultQuality | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Withdraw the request if it has not resolved yet; returns True
        when the cancellation won (the drain will drop it unlaunched)."""
        with self._lock:
            if self._event.is_set():
                return False
            self._cancelled = True
            self._exc = Cancelled(self.request_id)
            self._event.set()
            return True

    def set_result(self, result: SearchResult,
                   quality: ResultQuality | None = None) -> bool:
        """First resolution wins; returns whether this call resolved the
        future (so attribution — SLO, resolve spans — counts each
        request exactly once)."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self.quality = quality
            self._event.set()
            return True

    def set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exc = exc
            self._event.set()
            return True

    def exception(self) -> BaseException | None:
        return self._exc if self._event.is_set() else None

    def result(self, timeout: float | None = None) -> SearchResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not drained within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class _InFlight:
    """One dispatched, not-yet-synced batch riding the drain pipeline.

    Carries its bucket ``key``/``requests`` and dispatch ``attempt`` so
    a transient failure surfacing at sync time can be re-dispatched
    under the same bounded retry budget as a dispatch-time failure.
    ``event`` marks the end of the batch's launches on the card (None on
    the CPU, where the work has already run).
    """

    __slots__ = ("key", "staged", "result", "event", "t_dispatch",
                 "compiled", "attempt")

    def __init__(self, key, staged, result, event, t_dispatch, compiled,
                 attempt=0):
        self.key = key
        self.staged = staged
        self.result = result
        self.event = event
        self.t_dispatch = t_dispatch
        self.compiled = compiled
        self.attempt = attempt


class NeighborService:
    """The multi-tenant serving frontend over a :class:`SceneRegistry`.

    >>> svc = NeighborService()
    >>> svc.register_scene("city", points)
    >>> fut = svc.submit("city", queries, SearchParams(radius=0.1, k=8))
    >>> svc.drain()
    >>> res = fut.result()

    ``device`` is where the service's own registry keeps its scenes (the
    card unless the caller passes ``device="cpu"``); a caller's
    ``registry`` keeps its own device.
    """

    def __init__(self, opts: ServeOpts | None = None,
                 registry: SceneRegistry | None = None, *, device="cuda"):
        self.opts = opts if opts is not None else ServeOpts()
        # NOT `registry or ...`: an empty registry is falsy (__len__ == 0)
        # but still the caller's shared instance
        self.registry = (registry if registry is not None
                         else SceneRegistry(capacity=self.opts.scenes,
                                            device=device))
        self._batcher = MicroBatcher()
        self._lock = threading.RLock()
        self._seq = 0
        self._metrics = obs.metric_set("serve")
        self._batch_s = collections.deque(maxlen=32)   # recent drain times
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        # reliability state: one breaker per scene,
        # the repo-shared straggler detector over per-drain durations, and
        # a seeded jitter stream for the retry backoff
        self._breakers: dict = {}
        self._straggler = StragglerMonitor()
        self._jitter_rng = np.random.default_rng(self.opts.seed)

    # -- scene management ---------------------------------------------------

    def register_scene(self, scene_id, points, *, spec=None,
                       warm: tuple[SearchParams, int] | None = None):
        """Admit a static scene. ``warm=(params, nq)`` optionally builds
        the signature variant and serves its ``nq`` bucket once up front,
        so the first drained batch pays no first launch."""
        rec = self.registry.add_scene(scene_id, points, spec=spec)
        if warm is not None:
            params, nq = warm
            rec.variant(params).warm(nq)
        return rec

    def register_session(self, scene_id, session):
        """Admit a live ``SimulationSession`` as a dynamic scene (queries
        drain against its current frame)."""
        return self.registry.add_session(scene_id, session)

    # -- admission ----------------------------------------------------------

    def _retry_after(self) -> float:
        mean_batch = (sum(self._batch_s) / len(self._batch_s)
                      if self._batch_s else None)
        return self._batcher._retry_after(mean_batch, self.opts.max_batch,
                                          max(self.opts.retry_floor_s,
                                              self.opts.max_wait_s))

    def _breaker(self, scene_id) -> CircuitBreaker:
        br = self._breakers.get(scene_id)
        if br is None:
            br = self._breakers[scene_id] = CircuitBreaker(
                threshold=self.opts.breaker_n,
                cooldown_s=self.opts.breaker_cooldown_s)
        return br

    def submit(self, scene_id, queries, params: SearchParams,
               opts: SearchOpts = SearchOpts(), *,
               now: float | None = None,
               deadline_s: float | None = None) -> ServeFuture:
        """Admit one request; returns its future (resolved at drain time).

        Raises ``KeyError`` for a non-resident scene, ``QueryError`` for
        unservable inputs (NaN/inf/sentinel rows — rejected BEFORE they
        can reach a concatenated launch), ``CircuitOpen`` while the
        scene's breaker is open, and :class:`Rejected` past the
        ``max_pending`` high-water mark (unless ``ServeOpts.degrade``
        admits it at a reduced ladder level instead). ``now`` overrides
        the admission timestamp (simulated-clock trace replays);
        ``deadline_s`` the per-request server-side deadline (default
        ``ServeOpts.deadline_s``; 0/None = none).

        Every call is traced: the request gets a process-unique
        ``trace_id`` (on the returned future), the admission is recorded
        as an ``admit`` span carrying it, and refused admissions are
        attributed to the tenant's SLO ledger (``rejected`` /
        ``circuit_open``; ``QueryError`` counts as ``error``, and —
        being a reliability failure path — triggers a flight-recorder
        dump when ``REPRO_FLIGHT`` is on).
        """
        trace_id = f"req-{next(_REQ_IDS):06d}"
        with obs.span("admit", trace=trace_id,
                      tenant=str(scene_id)) as sp:
            try:
                return self._admit(scene_id, queries, params, opts,
                                   now=now, deadline_s=deadline_s,
                                   trace_id=trace_id, sp=sp)
            except QueryError:
                sp.set(outcome="error")
                slo.record(scene_id, "error")
                flightrec.note("query_error", scene=str(scene_id),
                               trace=trace_id)
                flightrec.dump(f"query_error:{scene_id}")
                raise
            except Rejected:
                sp.set(outcome="rejected")
                slo.record(scene_id, "rejected")
                raise
            except CircuitOpen:
                sp.set(outcome="circuit_open")
                slo.record(scene_id, "circuit_open")
                raise

    def _admit(self, scene_id, queries, params: SearchParams,
               opts: SearchOpts, *, now, deadline_s, trace_id,
               sp) -> ServeFuture:
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != 3:
            raise ValueError(f"queries must be [nq, 3], got {q.shape}")
        # fault-injection seam: a scheduled poison corrupts the admitted
        # rows (a byzantine client) — validation below must catch it
        q = faults.maybe_poison(q, scene=scene_id)
        if self.opts.validate:
            try:
                api.validate_queries(q)
            except QueryError:
                self._metrics.count("query_errors")
                raise
        with self._lock:
            if scene_id not in self.registry:
                raise KeyError(f"scene {scene_id!r} is not resident — "
                               "register_scene first")
            t_real = time.monotonic()
            t_perf = time.perf_counter()
            t_sched = t_real if now is None else float(now)
            br = self._breakers.get(scene_id)
            if br is not None and not br.submit_allowed(t_sched):
                self._metrics.count("circuit_open")
                raise CircuitOpen(scene_id, max(br.retry_after(t_sched),
                                                self.opts.retry_floor_s))
            degraded = False
            pending = self._batcher.pending_queries
            if pending + q.shape[0] > self.opts.max_pending:
                hard = int(self.opts.max_pending * self.opts.degrade_hard)
                if self.opts.degrade and pending + q.shape[0] <= hard:
                    # overload mode: serve at the reduced ladder level,
                    # flagged degraded, instead of rejecting
                    degraded = True
                    opts = dataclasses.replace(
                        opts, w_ladder=self.opts.degrade_ladder)
                    self._metrics.count("degraded_admissions")
                else:
                    self._metrics.count("rejected")
                    raise Rejected(pending, self.opts.max_pending,
                                   self._retry_after())
            ddl = self.opts.deadline_s if deadline_s is None \
                else float(deadline_s)
            self._seq += 1
            fut = ServeFuture(self._seq, trace_id)
            req = Request(seq=self._seq, scene_id=scene_id, params=params,
                          opts=opts, queries=q, future=fut,
                          t_submit=t_sched, t_real=t_real, t_perf=t_perf,
                          deadline=(t_sched + ddl if ddl else None),
                          degraded=degraded, trace_id=trace_id)
            sp.set(seq=self._seq, nq=q.shape[0], degraded=degraded)
            with obs.span("enqueue", trace=trace_id, nq=q.shape[0]):
                self._batcher.add(req)
            self._metrics.count("requests")
            self._metrics.count("query_rows", q.shape[0])
            self._gauge_depth()
        return fut

    def _gauge_depth(self) -> None:
        nreq, nq = self._batcher.queue_depth()
        self._metrics.gauge("queue_depth", nreq)
        self._metrics.gauge("queue_queries", nq)

    # -- drain --------------------------------------------------------------

    def _drop_dead(self, requests, now: float) -> list:
        """Filter a drained bucket down to launchable requests: expired
        deadlines fail with ``DeadlineExceeded`` and cancelled/already-
        resolved futures are dropped — all BEFORE any staging or launch,
        counted as ``serve.expired``."""
        live = []
        for r in requests:
            if r.future.done():                  # caller-cancelled
                self._metrics.count("cancelled")
            elif r.expired(now):
                if r.future.set_exception(
                        DeadlineExceeded(r.seq, r.deadline, now)):
                    self._metrics.count("expired")
                    self._resolve_span(r, "expired")
                    slo.record(r.scene_id, "expired")
            else:
                live.append(r)
        return live

    def _resolve_span(self, req, outcome: str, attempt: int = 0) -> None:
        """Record the request's terminal ``resolve`` span: it starts at the
        admission instant and ends now, both on the ``perf_counter`` clock
        the other spans use, so on the timeline it covers the request from
        admission to resolution exactly."""
        obs.record_span("resolve", time.perf_counter() - req.t_perf,
                        t0_s=req.t_perf,
                        trace=req.trace_id, tenant=str(req.scene_id),
                        seq=req.seq, outcome=outcome, attempt=attempt,
                        degraded=req.degraded)

    def _fail_requests(self, requests, exc: BaseException,
                       attempt: int = 0) -> None:
        outcome = ("circuit_open" if isinstance(exc, CircuitOpen)
                   else "expired" if isinstance(exc, DeadlineExceeded)
                   else "error")
        for r in requests:
            if r.future.set_exception(exc):
                self._resolve_span(r, outcome, attempt)
                slo.record(r.scene_id, outcome)

    def _backoff(self, attempt: int) -> None:
        base = self.opts.backoff_s * (2.0 ** attempt)
        time.sleep(min(base * (0.5 + float(self._jitter_rng.random())),
                       0.25))

    def _dispatch(self, key, requests, attempt: int = 0) -> _InFlight:
        """Stage (host concat/pad/upload) and asynchronously dispatch one
        batch through the scene variant's ``api.query``; on the card, mark
        the end of its launches with an event. A session-backed variant's
        step lock is held from reading its index through the last launch,
        so the batch reads one whole frame."""
        scene_id, params, sopts = key
        tids = [r.trace_id for r in requests]
        variant = self.registry.resolve(scene_id, params, sopts)
        # fault-injection seam: a scheduled launch fault fails the batch
        # before any device work (retried by _run_batch)
        faults.maybe_fail("launch", scene=scene_id)
        device = variant.device
        with obs.span("stage", trace_ids=tids, scene=str(scene_id)):
            staged = stage_batch(key, requests,
                                 variant.pad_to_bucket(
                                     sum(r.nq for r in requests)), device)
        # the bucket's first launch stands where the reference's compile
        # of a new serve program stood
        compiled = staged.pad_n not in variant.warmed
        t0 = time.perf_counter()
        with obs.span("launch", trace_ids=tids, scene=str(scene_id),
                      nq=staged.nq, pad_n=staged.pad_n, attempt=attempt):
            with variant.lock():
                result = variant.fn(variant.index, staged.queries)
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
        if compiled:
            variant.warmed.add(staged.pad_n)
            obs.record_span("compile", time.perf_counter() - t0,
                            trace_ids=tids)
        return _InFlight(key, staged, result, event, t0, compiled, attempt)

    def _run_batch(self, key, requests, now: float) -> _InFlight | None:
        """Dispatch one batch with the bounded transient-retry policy.

        Returns the in-flight record, or None when the batch failed
        permanently — in which case its futures are already failed and
        the scene's breaker has recorded the failure.
        """
        scene_id = key[0]
        attempt = 0
        while True:
            try:
                return self._dispatch(key, requests, attempt)
            except KeyError as exc:
                # scene evicted between admission and drain: fail the
                # batch's futures, keep serving (not a scene *fault* —
                # the breaker does not count residency churn)
                self._fail_requests(
                    requests, KeyError(f"scene {key[0]!r} evicted before "
                                       f"drain: {exc}"))
                self._metrics.count("failed_batches")
                return None
            except Exception as exc:
                if is_transient(exc) and attempt < self.opts.retries:
                    attempt += 1
                    self._metrics.count("retries")
                    flightrec.note("retry", scene=str(scene_id),
                                   attempt=attempt, error=str(exc))
                    self._backoff(attempt - 1)
                    continue
                self._fail_requests(requests, exc, attempt)
                self._metrics.count("failed_batches")
                self._metrics.count("launch_failures")
                flightrec.note("batch_failed", scene=str(scene_id),
                               error=str(exc), attempt=attempt,
                               seqs=[r.seq for r in requests])
                if self._breaker(scene_id).record_failure(now):
                    self._metrics.count("breaker_trips")
                    self._trip_breaker(scene_id)
                return None

    def _trip_breaker(self, scene_id) -> None:
        """A scene's circuit just opened — the canonical flight-recorder
        moment: note the transition and dump the post-mortem (a no-op
        unless ``REPRO_FLIGHT`` is on)."""
        flightrec.note("breaker_trip", scene=str(scene_id),
                       state=self.breaker_state(scene_id))
        flightrec.dump(f"breaker_open:{scene_id}")

    def _finish(self, flight: _InFlight, now_fn=time.monotonic) -> None:
        """The drained batch's ONE blocking host sync, then future
        resolution (device-sliced views — no further transfer)."""
        res = flight.result
        tids = [r.trace_id for r in flight.staged.requests]
        faults.maybe_delay(scene=flight.key[0])   # injected straggler
        with obs.span("sync", trace_ids=tids, scene=str(flight.key[0])):
            _wait(flight.event, res.indices.device)
        self._metrics.count("host_syncs")
        self._metrics.count("batches")
        dt = time.perf_counter() - flight.t_dispatch
        self._batch_s.append(dt)
        self._metrics.observe("batch_s", dt)
        # per-drain straggler detection: the repo-shared EMA monitor
        # (train.fault_tolerance) flags drains stalling >> steady state
        if self._straggler.observe(dt):
            self._metrics.count("stragglers")
        if self._straggler.ema is not None:
            self._metrics.gauge("batch_ema_s", self._straggler.ema)
        staged = flight.staged
        self._metrics.observe("batch_queries", staged.nq)
        self._metrics.observe("batch_requests", len(staged.requests))
        self._metrics.observe("batch_occupancy", staged.nq / staged.pad_n)
        scene_id, params, sopts = flight.key
        try:
            overflow, oob = self.registry.resolve(
                scene_id, params, sopts).quality_counters()
        except KeyError:               # evicted mid-flight; results stand
            overflow, oob = 0, 0
        now = now_fn()
        with obs.span("split", trace_ids=tids,
                      requests=len(staged.requests)):
            parts = split_result(staged, res)
        occupancy = staged.nq / staged.pad_n
        for req, res_i in zip(staged.requests, parts):
            quality = ResultQuality.from_counters(
                overflow=overflow, oob=oob, reduced_ladder=req.degraded)
            if quality.degraded:
                self._metrics.count("degraded_responses")
            if req.future.set_result(res_i, quality):
                outcome = "degraded" if req.degraded else "ok"
                self._resolve_span(req, outcome, flight.attempt)
                slo.record(req.scene_id, outcome,
                           max(0.0, now - req.t_real),
                           occupancy=occupancy)
            self._metrics.observe("request_s", max(0.0, now - req.t_real))
        self._metrics.count("resolved", len(staged.requests))
        flightrec.note("drain", scene=str(scene_id), nq=staged.nq,
                       pad_n=staged.pad_n, requests=len(staged.requests),
                       batch_s=dt, compiled=flight.compiled,
                       attempt=flight.attempt)

    def _finish_safe(self, flight: _InFlight, now: float) -> None:
        """Sync one in-flight batch, converting failures surfacing at
        sync time into the same bounded-retry / fail-futures / breaker
        policy as dispatch-time failures — a batch can never leave its
        futures unresolved."""
        scene_id = flight.key[0]
        try:
            self._finish(flight)
        except Exception as exc:
            if is_transient(exc) and flight.attempt < self.opts.retries:
                self._metrics.count("retries")
                flightrec.note("retry", scene=str(scene_id),
                               attempt=flight.attempt + 1, at="sync",
                               error=str(exc))
                self._backoff(flight.attempt)
                retry = self._run_batch(flight.key, flight.staged.requests,
                                        now)
                if retry is not None:
                    retry.attempt = max(retry.attempt, flight.attempt + 1)
                    self._finish_safe(retry, now)
                return
            self._fail_requests(flight.staged.requests, exc, flight.attempt)
            self._metrics.count("failed_batches")
            flightrec.note("batch_failed", scene=str(scene_id), at="sync",
                           error=str(exc), attempt=flight.attempt)
            if self._breaker(scene_id).record_failure(now):
                self._metrics.count("breaker_trips")
                self._trip_breaker(scene_id)
            return
        self._breaker(scene_id).record_success()

    def pump(self, now: float | None = None, *,
             force: bool = False) -> list[BatchReport]:
        """Drain every due bucket once; returns the batch reports in drain
        order (the deterministic record tests and launchers consume).

        The loop is pipelined: up to ``opts.pipeline`` dispatched batches
        stay in flight while the next one is staged on the host, and each
        batch's single blocking sync happens only when it leaves the
        pipeline (or at the end of the pump).

        Crash containment: if anything escapes the drain loop, every
        in-flight/taken request's future is failed with the escaping
        exception before it propagates — a pump crash can never strand a
        future unresolved.
        """
        with self._lock:
            now = time.monotonic() if now is None else float(now)
            reports: list[BatchReport] = []
            inflight: collections.deque = collections.deque()
            current: list = []
            try:
                with obs.span("pump", forced=force):
                    while True:
                        taken = self._batcher.take(
                            now, max_wait=self.opts.max_wait_s,
                            max_batch=self.opts.max_batch, force=force)
                        if taken is None:
                            break
                        key, current = taken
                        requests = self._drop_dead(current, now)
                        if not requests:
                            current = []
                            continue
                        scene_id = key[0]
                        br = self._breaker(scene_id)
                        if not br.allow(now):
                            # breaker open: isolate this scene — fail its
                            # batch fast, keep draining the others
                            self._fail_requests(requests, CircuitOpen(
                                scene_id, max(br.retry_after(now),
                                              self.opts.retry_floor_s)))
                            self._metrics.count("circuit_open",
                                                len(requests))
                            current = []
                            continue
                        with obs.span("drain", scene=str(scene_id),
                                      requests=len(requests),
                                      trace_ids=[r.trace_id
                                                 for r in requests]):
                            flight = self._run_batch(key, requests, now)
                        current = []
                        if flight is None:
                            continue
                        scene_id_k, params, _sopts = key
                        reports.append(BatchReport(
                            scene_id=scene_id_k, params=params,
                            seqs=tuple(r.seq for r in requests),
                            nq=flight.staged.nq, pad_n=flight.staged.pad_n))
                        inflight.append(flight)
                        # dispatch-then-stage: sync the OLDEST in-flight
                        # batch only once the pipeline is over depth, so
                        # the next iteration's staging overlapped this
                        # batch's execution
                        while len(inflight) > self.opts.pipeline:
                            self._finish_safe(inflight.popleft(), now)
                    while inflight:
                        self._finish_safe(inflight.popleft(), now)
            except BaseException as exc:
                # crash containment: no future may hang on a pump crash
                self._fail_requests(current, exc)
                for fl in inflight:
                    self._fail_requests(fl.staged.requests, exc)
                self._metrics.count("pump_crashes")
                flightrec.note("pump_crash", error=str(exc),
                               stranded=len(current) + sum(
                                   len(fl.staged.requests)
                                   for fl in inflight))
                flightrec.dump("pump_crash")
                raise
            finally:
                self._gauge_depth()
            return reports

    def drain(self, now: float | None = None) -> list[BatchReport]:
        """Force-pump until the admission queue is empty. ``now`` pins the
        scheduling clock (simulated-clock callers must drain on the same
        clock their deadlines were set against)."""
        reports: list[BatchReport] = []
        while True:
            got = self.pump(now, force=True)
            if not got:
                if self._batcher.empty():
                    break
                continue                 # only dead/isolated buckets drained
            reports.extend(got)
        return reports

    # -- background pump ----------------------------------------------------

    def start(self, poll_s: float | None = None) -> None:
        """Run the pump on a daemon thread (real streaming callers). The
        thread wakes every ``poll_s`` (default: half the bucket deadline)
        and drains whatever is due. Crash-contained: an exception escaping
        ``pump()`` (whose own handler already failed the in-flight
        futures) is counted as ``serve.pump_restarts`` and the loop keeps
        pumping instead of dying silently."""
        if self._thread is not None:
            return
        period = poll_s if poll_s is not None else \
            max(self.opts.max_wait_s / 2, 1e-4)
        self._stop_event.clear()
        device = self.registry.device
        if device.type == "cuda" and device.index is None:
            # "cuda" is the caller's current device; a new thread's current
            # device is 0, and set_device needs an index
            device = torch.device("cuda", torch.cuda.current_device())

        def loop():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            while not self._stop_event.wait(period):
                try:
                    self.pump()
                except Exception:
                    self._metrics.count("pump_restarts")

        self._thread = threading.Thread(target=loop,
                                        name="repro-torch-serve-pump",
                                        daemon=True)
        self._thread.start()

    def stop(self, final_drain: bool = True) -> None:
        if self._thread is None:
            return
        self._stop_event.set()
        self._thread.join()
        self._thread = None
        if final_drain:
            self.drain()

    # -- surface ------------------------------------------------------------

    def queue_depth(self) -> int:
        return self._batcher.pending_requests

    def breaker_state(self, scene_id) -> str:
        """The scene's circuit-breaker state ("closed" when untracked)."""
        br = self._breakers.get(scene_id)
        return br.state if br is not None else "closed"

    def stats(self) -> dict:
        nreq, nq = self._batcher.queue_depth()
        return {
            **self._metrics.counters(),
            "queue_depth": nreq,
            "queue_queries": nq,
            "breakers": {sid: br.state
                         for sid, br in self._breakers.items()},
            "registry": self.registry.stats(),
        }
