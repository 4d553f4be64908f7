"""repro_torch.reliability: fault model, error taxonomy and chaos tooling
of the serving layer (the reference's ``repro.reliability``).

* ``errors``  the request-outcome taxonomy: every admitted request
  resolves as exactly one of {result, ``QueryError``,
  ``DeadlineExceeded``, ``Rejected``, ``CircuitOpen``} (plus
  ``Cancelled`` for caller-cancelled futures);
* ``faults``  the deterministic seeded fault-injection harness
  (``REPRO_FAULTS`` knob, :class:`FaultPlan`) whose seams the service and
  the executor call;
* ``breaker`` the per-scene circuit-breaker state machine;
* ``quality`` per-response :class:`ResultQuality` flags derived from the
  device overflow/oob counters.
"""
from . import faults  # noqa: F401
from .breaker import CircuitBreaker  # noqa: F401
from .errors import (Cancelled, CircuitOpen, DeadlineExceeded,  # noqa: F401
                     InjectedFault, QueryError, TransientFault,
                     is_transient)
from .faults import FaultPlan  # noqa: F401
from .quality import ResultQuality  # noqa: F401

__all__ = [
    "Cancelled",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "FaultPlan",
    "InjectedFault",
    "QueryError",
    "ResultQuality",
    "TransientFault",
    "faults",
    "is_transient",
]
