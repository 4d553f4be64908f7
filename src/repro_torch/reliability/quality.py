"""Per-response result-quality flags (a copy of the reference's
``reliability/quality.py``; pure Python).

RT-kNNS Unbound's core observation (PAPERS.md) is that radius-capped
search *silently* drops true neighbors exactly where the device
counters already say so: a grid cell past ``capacity`` truncates its
occupants (``overflow``), and a point binned outside the frozen grid
(``oob``) is invisible to every window. The counters are
device-resident and cheap to read (a static scene's overflow is fetched
once; a session's ride its packed telemetry sync); this module attaches
them to every served response, so "this answer may
be missing neighbors" is a flag the caller sees instead of a silent
property of the scene.

``degraded`` is also set when the service deliberately served the
request at a reduced ladder level under overload (``ServeOpts.degrade``
— a bounded-window answer instead of a ``Rejected``): the classic
quality-for-availability trade, made explicit per response.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResultQuality:
    """Quality metadata riding every resolved ``ServeFuture``.

    ``exact``          no known loss source: full ladder, zero scene
                       overflow/oob — the response is bitwise what
                       ``api.query`` returns for this request alone.
    ``degraded``       at least one loss source applied (the union of
                       the flags below).
    ``reduced_ladder`` served at the overload ladder (bounded window):
                       neighbors beyond the capped window are absent.
    ``overflow``       scene-side truncated points (cell capacity); >0
                       means true neighbors may be missing anywhere.
    ``oob``            scene points outside the frozen grid this frame
                       (dynamic scenes mid-respec); >0 means those
                       points are invisible to the search.
    ``reason``         short human tag ("" when exact).
    """

    degraded: bool = False
    reduced_ladder: bool = False
    overflow: int = 0
    oob: int = 0
    reason: str = ""

    @property
    def exact(self) -> bool:
        return not self.degraded

    @classmethod
    def from_counters(cls, *, overflow: int = 0, oob: int = 0,
                      reduced_ladder: bool = False) -> "ResultQuality":
        overflow, oob = int(overflow), int(oob)
        reasons = []
        if reduced_ladder:
            reasons.append("overload ladder cap")
        if overflow > 0:
            reasons.append(f"scene overflow={overflow}")
        if oob > 0:
            reasons.append(f"scene oob={oob}")
        return cls(degraded=bool(reasons), reduced_ladder=reduced_ladder,
                   overflow=overflow, oob=oob, reason="; ".join(reasons))


EXACT = ResultQuality()
