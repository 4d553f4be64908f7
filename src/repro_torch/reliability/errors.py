"""Error taxonomy of the port: the structured input-validation failure
raised by ``api.validate_queries``. The serving layer's other outcomes
(deadlines, rejection, circuit breakers) are not ported yet."""
from __future__ import annotations


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
