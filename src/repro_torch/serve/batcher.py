"""Admission queue + signature-bucket micro-batcher (the reference's
``serve/batcher.py`` on PyTorch).

In-flight requests from many logical clients are grouped by **bucket key**
``(scene id, SearchParams, SearchOpts)`` — the signature that determines
which compiled serve program a launch runs through — and drained as ONE
concatenated launch per bucket: the paper's coalescing lesson applied
across tenants instead of across a single caller's queries. Two knobs
bound the latency/throughput trade:

* ``max_batch`` — at most this many concatenated query rows drain per
  launch (whole requests only; an oversized single request drains alone),
  so throughput saturates with dense, bounded launches under heavy load;
* ``max_wait`` — a bucket becomes *due* once its oldest request has waited
  this long even if far from full, so latency is bounded under light load.

Drain order is deterministic given the submission order: buckets are
picked **round-robin over scenes** (per-scene fairness — a hot tenant
flooding one bucket cannot starve the others; its surplus waits for later
rounds) and FIFO within a scene and within a bucket. The drain loop is
**pipelined**: batch N+1 is staged (host concat/pad/upload) and dispatched
while batch N still executes on device, and only then is batch N synced —
the one blocking host sync per drained batch.

Staging on the card: the batch is concatenated and edge-padded on the host
straight into a pinned CPU tensor, which is uploaded with
``non_blocking=True`` (an asynchronous copy, no sync). The
:class:`StagedBatch` keeps the pinned buffer until the batch's sync, so it
is not reused while the copy may still be in flight. On the CPU the host
tensor is the batch.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from ..core.types import SearchOpts, SearchParams, SearchResult


@dataclasses.dataclass
class Request:
    """One admitted request: ``queries`` [nq, 3] against one scene under
    one search signature. ``seq`` is the admission sequence number (the
    total order every drain decision derives from). ``t_submit`` is the
    *scheduling* timestamp the bucket deadline ages against — simulated
    trace replays may supply a virtual clock — while ``t_real`` is always
    the monotonic wall time latency metrics are measured from.

    ``t_perf`` is the admission instant on the ``time.perf_counter``
    clock, the clock every span is stamped with: the request's ``resolve``
    span starts there, so its timeline covers admission to resolution on
    one clock.

    ``deadline`` (same clock as ``t_submit``; None = no deadline) is the
    server-side expiry: a request past it is dropped at bucket drain,
    BEFORE launch, and its future fails with ``DeadlineExceeded``.
    ``degraded`` marks requests admitted under
    the overload ladder cap (``ServeOpts.degrade``): they serve at a
    reduced window and their responses carry a degraded
    ``ResultQuality`` flag.

    ``trace_id`` is the request-scoped trace context: a process-unique
    ``req-NNNNNN`` id assigned at admission that every span touching this
    request carries — per-request spans as the
    top-level ``trace`` field, batch-granular spans in a ``trace_ids``
    attribute — so ``obs.timeline(trace_id)`` reconstructs the request's
    full admission-to-resolution story."""

    seq: int
    scene_id: object
    params: SearchParams
    opts: SearchOpts
    queries: np.ndarray
    future: object
    t_submit: float
    t_real: float
    t_perf: float
    deadline: float | None = None
    degraded: bool = False
    trace_id: str = ""

    @property
    def nq(self) -> int:
        return int(self.queries.shape[0])

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """What one drained launch contained (returned by ``Service.pump`` —
    the deterministic drain-order record the tests assert on)."""

    scene_id: object
    params: SearchParams
    seqs: tuple
    nq: int
    pad_n: int


class _Bucket:
    __slots__ = ("key", "requests", "nq_total")

    def __init__(self, key):
        self.key = key
        self.requests: collections.deque = collections.deque()
        self.nq_total = 0

    def push(self, req: Request) -> None:
        self.requests.append(req)
        self.nq_total += req.nq

    @property
    def t_oldest(self) -> float:
        return self.requests[0].t_submit


class MicroBatcher:
    """The pending-request store: buckets by signature, fairness by scene."""

    def __init__(self):
        self._buckets: collections.OrderedDict = collections.OrderedDict()
        # per-scene FIFO of bucket keys with pending work + the round-robin
        # cursor over scene ids (fairness across tenants)
        self._scene_keys: collections.OrderedDict = collections.OrderedDict()
        self._rr: collections.deque = collections.deque()
        self.pending_requests = 0
        self.pending_queries = 0

    # -- admission ----------------------------------------------------------

    def add(self, req: Request) -> None:
        key = (req.scene_id, req.params, req.opts)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(key)
            keys = self._scene_keys.get(req.scene_id)
            if keys is None:
                keys = self._scene_keys[req.scene_id] = collections.deque()
                self._rr.append(req.scene_id)
            keys.append(key)
        bucket.push(req)
        self.pending_requests += 1
        self.pending_queries += req.nq

    def empty(self) -> bool:
        return not self._buckets

    def queue_depth(self) -> tuple[int, int]:
        return self.pending_requests, self.pending_queries

    def oldest_wait(self, now: float) -> float:
        """Age of the oldest pending request (0 when idle) — the scheduling
        statistic a background pump loop polls."""
        if not self._buckets:
            return 0.0
        return max(0.0, now - min(b.t_oldest
                                  for b in self._buckets.values()))

    def _retry_after(self, mean_batch_s: float | None, max_batch: int,
                     floor_s: float) -> float:
        """Retry-after estimate for a rejected admission: roughly how
        long until the current backlog has drained, from the mean recent
        drain time. Hardened for cold start: before
        any drain has completed — or when the estimate is degenerate
        (zero, negative, NaN, inf) — the configured ``floor_s`` is
        returned instead of 0/NaN, so clients always get a usable
        positive backoff hint."""
        floor_s = max(float(floor_s), 1e-6)
        if (mean_batch_s is None or not math.isfinite(mean_batch_s)
                or mean_batch_s <= 0.0):
            mean_batch_s = floor_s
        backlog = self.pending_queries / max(int(max_batch), 1)
        est = mean_batch_s * max(backlog, 1.0)
        if not math.isfinite(est) or est <= 0.0:
            return floor_s
        return max(floor_s, est)

    # -- drain selection ----------------------------------------------------

    def _due(self, bucket: _Bucket, now: float, max_wait: float,
             max_batch: int, force: bool) -> bool:
        if force:
            return True
        return (bucket.nq_total >= max_batch
                or (now - bucket.t_oldest) >= max_wait)

    def take(self, now: float, *, max_wait: float, max_batch: int,
             force: bool = False) -> tuple[object, list[Request]] | None:
        """Pop the next due batch ``(bucket_key, requests)`` under the
        scene round-robin, or None when nothing is due.

        Takes whole requests FIFO up to ``max_batch`` query rows (at least
        one request always drains, so an oversized request still ships —
        alone). A bucket left non-empty keeps its queue position; the
        round-robin cursor advances past the drained scene either way.
        """
        for _ in range(len(self._rr)):
            scene_id = self._rr[0]
            self._rr.rotate(-1)
            keys = self._scene_keys[scene_id]
            for key in list(keys):
                bucket = self._buckets[key]
                if not self._due(bucket, now, max_wait, max_batch, force):
                    continue
                taken: list[Request] = []
                nq = 0
                while bucket.requests and (
                        not taken or nq + bucket.requests[0].nq <= max_batch):
                    req = bucket.requests.popleft()
                    bucket.nq_total -= req.nq
                    nq += req.nq
                    taken.append(req)
                if not bucket.requests:
                    del self._buckets[key]
                    keys.remove(key)
                    if not keys:
                        del self._scene_keys[scene_id]
                        self._rr.remove(scene_id)
                self.pending_requests -= len(taken)
                self.pending_queries -= nq
                return key, taken
        return None


@dataclasses.dataclass
class StagedBatch:
    """One batch after host staging: the concatenated, bucket-padded query
    upload plus the per-request split offsets. ``host`` is the (pinned, on
    the card) host buffer the upload was copied from; it is held until the
    batch's sync."""

    key: object
    requests: list
    queries: torch.Tensor         # [pad_n, 3] float32 on the device
    offsets: list                 # len(requests)+1 prefix sums
    nq: int
    pad_n: int
    host: torch.Tensor


def stage_batch(key, requests: list, pad_n: int,
                device: torch.device) -> StagedBatch:
    """Concatenate the batch's query rows, edge-pad to the launch bucket
    (padded rows repeat the last real query — the executor's idempotent
    padding discipline), and upload to ``device`` without a sync. Host work
    plus an asynchronous copy: this is the stage the drain loop overlaps
    with the PREVIOUS batch's device execution."""
    arrays = [r.queries for r in requests]
    offsets = np.cumsum([0] + [a.shape[0] for a in arrays]).tolist()
    nq = offsets[-1]
    host = torch.empty((pad_n, 3), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    np.concatenate(arrays, axis=0, out=buf[:nq])
    buf[nq:] = buf[nq - 1]
    return StagedBatch(key=key, requests=requests,
                       queries=host.to(device, non_blocking=True),
                       offsets=offsets, nq=nq, pad_n=pad_n, host=host)


def split_result(staged: StagedBatch, result: SearchResult) -> list:
    """Per-request ``SearchResult`` views of one drained launch's output
    (device slices — no host transfer)."""
    out = []
    for a, b in zip(staged.offsets[:-1], staged.offsets[1:]):
        out.append(SearchResult(indices=result.indices[a:b],
                                distances2=result.distances2[a:b],
                                counts=result.counts[a:b]))
    return out
