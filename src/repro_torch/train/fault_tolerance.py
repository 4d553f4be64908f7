"""Fault tolerance of the port: ``StragglerMonitor`` (a copy of the
reference's ``train/fault_tolerance.py:29-46``; pure Python), which the
serve pump uses to flag drains that stall far past the steady state.
``ResilientLoop`` and ``remesh`` wait for the training slice."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    """EMA of step (or drain) durations; flags a duration above
    ``factor`` x EMA as a straggler, which then does not move the EMA."""

    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.1
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        """Record one step duration; returns True if it is a straggler."""
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.factor * self.ema
        if is_straggler:
            self.flagged += 1
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler
