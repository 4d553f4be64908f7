"""Per-scene circuit breaker (a copy of the reference's
``reliability/breaker.py``; pure Python).

The failure mode this isolates: one tenant's scene keeps failing its
launches (a poisoned index, a pathological signature, an injected fault
schedule) and, without a breaker, every drain cycle burns its retry
budget against that scene while other tenants' buckets wait behind it.

Classic three-state machine, driven entirely by the caller's clock (the
serve pump passes its own ``now`` — virtual in trace replays and tests,
monotonic in production — so breaker behavior is deterministic under a
simulated clock):

* ``CLOSED``    — normal service. ``failures`` counts *consecutive*
                  batch failures; a success resets it; reaching
                  ``threshold`` trips to OPEN.
* ``OPEN``      — fail fast: every ``allow()`` is False (the pump fails
                  that scene's drained buckets with ``CircuitOpen``
                  without launching; ``submit_allowed`` lets the
                  admission path reject before queueing) until
                  ``cooldown_s`` has elapsed.
* ``HALF_OPEN`` — after the cooldown, exactly ONE probe batch is let
                  through. Success closes the breaker (full reset);
                  failure re-opens it with the cooldown doubled (capped
                  at ``cooldown_max_s``), so a persistently-broken scene
                  backs off geometrically instead of probing at a fixed
                  rate.
"""
from __future__ import annotations

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One scene's breaker; the serve pump owns one per scene id."""

    __slots__ = ("threshold", "cooldown_s", "cooldown_max_s", "state",
                 "failures", "opened_at", "_cooldown", "_probing",
                 "trips", "probes")

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.05,
                 cooldown_max_s: float | None = None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        # default cap scales with the base so geometric backoff always has
        # headroom (a fixed cap below cooldown_s would SHRINK on "doubling")
        self.cooldown_max_s = (float(cooldown_max_s)
                               if cooldown_max_s is not None
                               else max(100.0 * self.cooldown_s, 5.0))
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self._cooldown = self.cooldown_s
        self._probing = False
        self.trips = 0
        self.probes = 0

    # -- gates --------------------------------------------------------------

    def allow(self, now: float) -> bool:
        """May a drained batch for this scene launch at ``now``? In OPEN,
        flips to HALF_OPEN (returning True exactly once — the probe) when
        the cooldown has elapsed."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now - self.opened_at < self._cooldown:
                return False
            self.state = HALF_OPEN
            self._probing = False
        # HALF_OPEN: one probe at a time
        if self._probing:
            return False
        self._probing = True
        self.probes += 1
        return True

    def submit_allowed(self, now: float) -> bool:
        """May a new request for this scene even be admitted at ``now``?
        False only while OPEN inside the cooldown — half-open admits (the
        queue feeds the probe)."""
        return not (self.state == OPEN
                    and now - self.opened_at < self._cooldown)

    def retry_after(self, now: float) -> float:
        """Cooldown remaining (the ``CircuitOpen.retry_after_s`` hint)."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self._cooldown - (now - self.opened_at))

    # -- outcomes -----------------------------------------------------------

    def record_success(self) -> None:
        self.failures = 0
        self._probing = False
        if self.state != CLOSED:
            self.state = CLOSED
            self._cooldown = self.cooldown_s        # full reset
        return None

    def record_failure(self, now: float) -> bool:
        """Record one batch failure; returns True when this trips (or
        re-trips) the breaker open."""
        self._probing = False
        if self.state == HALF_OPEN:
            # failed probe: back off geometrically
            self.state = OPEN
            self.opened_at = now
            self._cooldown = min(self._cooldown * 2.0, self.cooldown_max_s)
            self.trips += 1
            return True
        self.failures += 1
        if self.state == CLOSED and self.failures >= self.threshold:
            self.state = OPEN
            self.opened_at = now
            self.trips += 1
            return True
        return False
