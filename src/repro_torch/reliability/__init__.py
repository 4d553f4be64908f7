"""repro_torch.reliability: the error taxonomy (``QueryError``,
``InjectedFault``) and the deterministic fault-injection harness
(``faults``) whose seams the executor calls. The circuit breaker and the
result-quality flags are not ported yet."""
from . import faults  # noqa: F401
from .errors import (InjectedFault, QueryError,  # noqa: F401
                     TransientFault, is_transient)
from .faults import FaultPlan  # noqa: F401

__all__ = ["FaultPlan", "InjectedFault", "QueryError", "TransientFault",
           "faults", "is_transient"]
