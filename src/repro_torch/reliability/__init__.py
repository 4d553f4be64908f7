"""repro_torch.reliability: the error taxonomy (``QueryError``)."""
from .errors import QueryError  # noqa: F401

__all__ = ["QueryError"]
