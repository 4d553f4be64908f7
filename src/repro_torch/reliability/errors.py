"""Error taxonomy of the port: the structured input-validation failure
raised by ``api.validate_queries``, and the injected fault that
``reliability.faults`` raises at the executor's seams. The serving layer's
other outcomes (deadlines, rejection, circuit breakers) are not ported
yet.

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


def is_transient(exc: BaseException) -> bool:
    """The retry policy's predicate."""
    return isinstance(exc, TransientFault)
