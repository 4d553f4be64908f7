"""Per-tenant SLO accounting (a copy of the reference's ``obs/slo.py``;
pure Python).

The metrics registry answers "what did the whole process
do"; this module answers the multi-tenant question the AMR/skew papers
motivate: *which tenant* is seeing the latency, and who is burning an
error budget. A process-wide :class:`SLOBoard` keeps one windowed
good/bad ledger per tenant (tenant == serve scene id), fed by the
service on every terminal outcome:

* ``ok`` / ``degraded``   — resolved futures (degraded = admitted under
  the overload ladder); *good* iff the end-to-end latency met the
  tenant's :class:`SLOTarget` threshold (or no target is armed);
* ``expired`` / ``rejected`` / ``circuit_open`` / ``error`` — *bad*.

Targets are declarative: ``SLOTarget(latency_s, objective, window_s)``
reads "``objective`` of requests in any ``window_s`` window resolve ok
within ``latency_s``". ``attainment(tenant)`` is the windowed good
fraction; ``burn_rate(tenant)`` the classic error-budget burn —
``bad_fraction / (1 - objective)``, >1 meaning the budget is burning
faster than the SLO allows. The default target comes from the
``REPRO_SLO`` knob (``latency_ms:250,objective:0.99,window_s:300``);
per-tenant overrides via :func:`set_target`.

The board always counts (outcome tallies are what the chaos gate's
per-tenant table and ``obs_top`` render); only the *gating* semantics
need a target. State is component-local and registers with the
``obs.lifecycle`` reset hook, so ``obs.reset()`` clears it.
"""
from __future__ import annotations

import os
import threading
import time

from .lifecycle import on_reset
from .registry import Histogram

#: outcomes that count toward the good side of the ledger (latency
#: permitting); everything else is bad. ``cancelled`` is deliberately
#: absent from both — a caller that gave up does not burn server budget.
GOOD_OUTCOMES = ("ok", "degraded")
BAD_OUTCOMES = ("expired", "rejected", "circuit_open", "error")
OUTCOMES = GOOD_OUTCOMES + BAD_OUTCOMES

_EVENTS_MAX = 4096      # windowed events kept per tenant


class SLOTarget:
    """One declarative objective: ``objective`` of requests within any
    ``window_s`` window resolve within ``latency_s``."""

    __slots__ = ("latency_s", "objective", "window_s")

    def __init__(self, latency_s: float = 0.25, objective: float = 0.99,
                 window_s: float = 300.0):
        self.latency_s = float(latency_s)
        self.objective = float(objective)
        self.window_s = float(window_s)
        if not 0.0 < self.objective <= 1.0:
            raise ValueError(f"objective {objective} not in (0, 1]")
        if self.latency_s <= 0.0 or self.window_s <= 0.0:
            raise ValueError("latency_s and window_s must be > 0")

    def error_budget(self) -> float:
        return 1.0 - self.objective

    def spec(self) -> str:
        return (f"latency_ms:{self.latency_s * 1e3:g},"
                f"objective:{self.objective:g},"
                f"window_s:{self.window_s:g}")

    @classmethod
    def parse(cls, spec: str) -> "SLOTarget":
        """Parse a ``REPRO_SLO`` spec string (see module docstring)."""
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(f"REPRO_SLO entry {part!r} is not "
                                 f"'key:value'")
            key, val = (s.strip() for s in part.split(":", 1))
            if key == "latency_ms":
                kw["latency_s"] = float(val) / 1e3
            elif key in ("latency_s", "objective", "window_s"):
                kw[key] = float(val)
            else:
                raise ValueError(
                    f"unknown REPRO_SLO key {key!r} (expected latency_ms, "
                    f"latency_s, objective, window_s)")
        return cls(**kw)

    def __repr__(self):
        return f"SLOTarget({self.spec()})"


class _TenantState:
    """One tenant's ledger: windowed (t, good) events, lifetime outcome
    tallies, and a latency histogram for the per-tenant percentiles."""

    __slots__ = ("events", "outcomes", "latency", "occupancy")

    def __init__(self):
        import collections
        self.events: "collections.deque" = collections.deque(
            maxlen=_EVENTS_MAX)
        self.outcomes: dict = {k: 0 for k in OUTCOMES}
        self.latency = Histogram()
        self.occupancy = Histogram()


class SLOBoard:
    """Process-wide per-tenant SLO ledger (one instance: ``BOARD``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict = {}
        self._targets: dict = {}
        self._default: SLOTarget | None = None
        self._env_read = False

    # -- configuration ------------------------------------------------------

    def configure(self, target: SLOTarget | None = None, *,
                  from_env: bool = False) -> SLOTarget | None:
        """Set the default target (None disarms gating), or re-read the
        ``REPRO_SLO`` knob."""
        with self._lock:
            if from_env:
                spec = os.environ.get("REPRO_SLO", "")
                self._default = SLOTarget.parse(spec) if spec else None
            else:
                self._default = target
            self._env_read = True
            return self._default

    def default_target(self) -> SLOTarget | None:
        with self._lock:
            if not self._env_read:
                spec = os.environ.get("REPRO_SLO", "")
                self._default = SLOTarget.parse(spec) if spec else None
                self._env_read = True
            return self._default

    def set_target(self, tenant, target: SLOTarget) -> None:
        with self._lock:
            self._targets[str(tenant)] = target

    def target(self, tenant) -> SLOTarget | None:
        t = self._targets.get(str(tenant))
        return t if t is not None else self.default_target()

    # -- recording ----------------------------------------------------------

    def record(self, tenant, outcome: str, latency_s: float | None = None,
               *, now: float | None = None,
               occupancy: float | None = None) -> None:
        """Attribute one terminal request outcome to ``tenant``.
        ``latency_s`` is the end-to-end latency of a resolved future
        (None for outcomes that never resolved). Unknown outcome names
        count as ``error`` rather than raising — the board must never
        take the serving path down."""
        tenant = str(tenant)
        if outcome not in OUTCOMES:
            outcome = "error"
        tgt = self.target(tenant)
        good = outcome in GOOD_OUTCOMES and (
            latency_s is None or tgt is None or latency_s <= tgt.latency_s)
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = _TenantState()
            st.events.append((t, good))
            st.outcomes[outcome] += 1
            if latency_s is not None:
                st.latency.observe(latency_s)
            if occupancy is not None:
                st.occupancy.observe(occupancy)

    # -- reading ------------------------------------------------------------

    def tenants(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    def _window_counts(self, st: _TenantState, window_s: float,
                       now: float) -> tuple[int, int]:
        lo = now - window_s
        good = bad = 0
        for t, g in st.events:
            if t < lo:
                continue
            if g:
                good += 1
            else:
                bad += 1
        return good, bad

    def attainment(self, tenant, now: float | None = None) -> float:
        """Windowed good fraction for ``tenant`` (1.0 with no traffic —
        an idle tenant is not out of SLO)."""
        tenant = str(tenant)
        with self._lock:
            st = self._tenants.get(tenant)
        if st is None:
            return 1.0
        tgt = self.target(tenant)
        window = tgt.window_s if tgt is not None else float("inf")
        now = time.monotonic() if now is None else float(now)
        good, bad = self._window_counts(st, window, now)
        total = good + bad
        return good / total if total else 1.0

    def burn_rate(self, tenant, now: float | None = None) -> float:
        """Error-budget burn in the window: bad fraction over the
        target's error budget. 0 with no traffic or no bad events;
        ``inf`` when bad events exist against a zero budget
        (objective == 1)."""
        tenant = str(tenant)
        with self._lock:
            st = self._tenants.get(tenant)
        if st is None:
            return 0.0
        tgt = self.target(tenant)
        window = tgt.window_s if tgt is not None else float("inf")
        now = time.monotonic() if now is None else float(now)
        good, bad = self._window_counts(st, window, now)
        total = good + bad
        if total == 0 or bad == 0:
            return 0.0
        budget = tgt.error_budget() if tgt is not None else 1.0
        frac = bad / total
        return frac / budget if budget > 0 else float("inf")

    def snapshot(self, now: float | None = None) -> dict:
        """{tenant: {outcomes, requests, attainment, burn_rate, target,
        latency percentiles, occupancy p50}} — the machine-readable
        per-tenant table (obs_top, openmetrics, the chaos gate)."""
        now = time.monotonic() if now is None else float(now)
        out = {}
        for tenant in self.tenants():
            with self._lock:
                st = self._tenants[tenant]
                outcomes = dict(st.outcomes)
                lat = st.latency.snapshot()
                occ = st.occupancy
                occ_p50 = occ.percentiles()["p50"] if occ.count else None
            tgt = self.target(tenant)
            out[tenant] = {
                "outcomes": outcomes,
                "requests": sum(outcomes.values()),
                "attainment": self.attainment(tenant, now=now),
                "burn_rate": self.burn_rate(tenant, now=now),
                "target": tgt.spec() if tgt is not None else None,
                "objective": tgt.objective if tgt is not None else None,
                "latency": lat,
                "occupancy_p50": occ_p50,
            }
        return out

    def summary(self, now: float | None = None) -> str:
        """Human-readable per-tenant table (the serve-figure and chaos
        gate rendering)."""
        snap = self.snapshot(now=now)
        lines = ["# per-tenant SLO",
                 f"# {'tenant':<14}{'req':>6}{'ok':>6}{'degr':>6}{'expd':>6}"
                 f"{'rej':>6}{'copen':>7}{'err':>5}{'attain':>8}{'obj':>7}"
                 f"{'burn':>7}{'p50_ms':>9}{'p99_ms':>9}"]
        if not snap:
            lines.append("# (no tenant traffic recorded)")
        for tenant, row in snap.items():
            oc, lat = row["outcomes"], row["latency"]
            obj = f"{row['objective']:.3f}" if row["objective"] else "-"
            burn = row["burn_rate"]
            lines.append(
                f"# {tenant:<14}{row['requests']:>6}{oc['ok']:>6}"
                f"{oc['degraded']:>6}{oc['expired']:>6}{oc['rejected']:>6}"
                f"{oc['circuit_open']:>7}{oc['error']:>5}"
                f"{row['attainment']:>8.3f}{obj:>7}"
                f"{('inf' if burn == float('inf') else f'{burn:.2f}'):>7}"
                f"{lat.get('p50', 0.0) * 1e3:>9.2f}"
                f"{lat.get('p99', 0.0) * 1e3:>9.2f}")
        return "\n".join(lines)

    def violations(self, now: float | None = None) -> dict:
        """{tenant: (attainment, objective)} for every tenant currently
        below its armed objective — the chaos-gate predicate. Empty when
        no target is armed."""
        out = {}
        for tenant in self.tenants():
            tgt = self.target(tenant)
            if tgt is None:
                continue
            att = self.attainment(tenant, now=now)
            if att < tgt.objective:
                out[tenant] = (att, tgt.objective)
        return out

    def reset(self) -> None:
        """Clear every tenant ledger and per-tenant target override
        (the default/env target survives — it is configuration, not
        state). Registered with ``obs.lifecycle.on_reset``."""
        with self._lock:
            self._tenants.clear()
            self._targets.clear()


BOARD = SLOBoard()
on_reset(BOARD.reset)

# module-level conveniences (the service call sites)
configure = BOARD.configure
default_target = BOARD.default_target
set_target = BOARD.set_target
record = BOARD.record
attainment = BOARD.attainment
burn_rate = BOARD.burn_rate
snapshot = BOARD.snapshot
summary = BOARD.summary
violations = BOARD.violations
