"""Error taxonomy of the port (the reference's ``reliability/errors.py``).

Every request admitted to ``serve.NeighborService`` resolves as exactly
ONE of:

* a ``SearchResult`` (possibly flagged degraded, see ``quality.py``);
* ``QueryError``       the input itself is unservable (NaN/inf rows,
                       sentinel-colliding coordinates, out-of-domain when
                       bounds are enforced). Raised *before* the request
                       can reach a device launch, so one tenant's poisoned
                       rows can never taint a concatenated batch;
* ``DeadlineExceeded`` the request's server-side deadline expired while it
                       waited in the admission queue; it is dropped at
                       bucket drain, before launch;
* ``Rejected``         admission refused past the pending high-water mark
                       (defined in ``serve.service``; carries a
                       retry-after estimate);
* ``CircuitOpen``      the target scene's circuit breaker is open
                       (repeated launch failures); the scene is isolated
                       while other tenants keep draining;

plus ``Cancelled`` for caller-cancelled futures. ``InjectedFault`` is what
``reliability.faults`` raises at the service's and the executor's seams.

``TransientFault`` is the marker mixin a retry policy keys on: a launch
failure that is transient (an injected fault, a transient runtime error)
is worth retrying; anything else is not.
"""
from __future__ import annotations


class TransientFault:
    """Marker mixin: failures that are worth retrying (bounded, with
    backoff). The fault-injection harness raises these; real transient
    launch errors can subclass or be wrapped."""


class InjectedFault(TransientFault, RuntimeError):
    """A deterministic fault injected by ``reliability.faults``.

    ``kind`` is the injection site ("launch", "compile", ...); ``site``
    the full decision key (site plus scope), ``n`` the per-site decision
    counter: together they identify the exact injection for replay.
    """

    def __init__(self, kind: str, site: str, n: int):
        super().__init__(f"injected {kind} fault (site={site}, n={n})")
        self.kind = kind
        self.site = site
        self.n = n


class QueryError(ValueError):
    """Structured input-validation failure (``api.validate_queries``).

    ``reasons`` maps reason -> offending row count (``"nan"``,
    ``"inf"``, ``"oob"``); ``rows`` lists the first offending row
    indices (bounded) so callers can pinpoint the poison.
    """

    def __init__(self, reasons: dict, rows, nq: int):
        self.reasons = dict(reasons)
        self.rows = list(rows)
        self.nq = int(nq)
        detail = ", ".join(f"{k}={v}" for k, v in self.reasons.items())
        super().__init__(
            f"unservable queries ({detail} of {nq} rows; first bad rows "
            f"{self.rows})")


class DeadlineExceeded(RuntimeError):
    """The request's server-side deadline expired before its bucket
    drained; it was dropped WITHOUT being launched."""

    def __init__(self, request_id: int, deadline: float, now: float):
        super().__init__(
            f"request {request_id} deadline expired "
            f"{(now - deadline) * 1e3:.1f}ms before drain; dropped unlaunched")
        self.request_id = request_id
        self.deadline = deadline


class Cancelled(RuntimeError):
    """The caller cancelled the future (``ServeFuture.cancel``); the
    request was dropped at bucket drain without being launched."""

    def __init__(self, request_id: int):
        super().__init__(f"request {request_id} cancelled by caller")
        self.request_id = request_id


class CircuitOpen(RuntimeError):
    """The scene's circuit breaker is open: recent drains against it
    failed ``threshold`` consecutive times, so it is isolated until the
    half-open probe succeeds. Retry after ``retry_after_s`` (or against
    another scene)."""

    def __init__(self, scene_id, retry_after_s: float):
        super().__init__(
            f"scene {scene_id!r} circuit breaker is open; retry after "
            f"~{retry_after_s * 1e3:.1f}ms")
        self.scene_id = scene_id
        self.retry_after_s = retry_after_s


def is_transient(exc: BaseException) -> bool:
    """The retry policy's predicate."""
    return isinstance(exc, TransientFault)
