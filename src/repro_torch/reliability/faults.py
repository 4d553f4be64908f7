"""Deterministic fault-injection harness.

Chaos testing needs failures that are *reproducible*: the same seeded
plan must inject the same faults at the same decision points on every
run, so a chaos trace that hangs a caller is a test case, not a flake. A
:class:`FaultPlan` holds per-site injection rates; each decision is a
pure hash of ``(seed, site, decision counter)``: no hidden RNG state, no
cross-site coupling, thread-safe.

Injection sites (each a named seam the production code already owns):

* ``launch``     - raise :class:`~.errors.InjectedFault` where a batch
                   or a query is dispatched to the device (the
                   ``serve.service`` drain,
                   ``core.executor.QueryExecutor.execute_async``);
* ``compile``    - raise at the build seam (``executor._get_launcher``
                   on a launcher-cache miss);
* ``straggler``  - sleep ``delay_s`` before the blocking result wait
                   (the serve batch's sync, ``PendingResult.wait``), a
                   straggler the serve pump's ``StragglerMonitor`` must
                   flag, not hang on;
* ``poison``     - corrupt admitted query rows with NaN (what input
                   validation must catch before launch).

Activation: ``install(plan)`` for tests, ``scoped(plan)`` as a context
manager, or the ``REPRO_FAULTS`` knob for whole-process chaos runs::

    REPRO_FAULTS="launch:0.2,straggler:0.1,seed:7" \\
        python -m repro_torch.launch.serve --trace short

Spec grammar: comma-separated ``site:rate`` pairs plus the optional
modifiers ``seed:<int>``, ``delay_ms:<float>`` (straggler sleep),
``scene:<id>`` (inject only against that scene — how a chaos test
poisons one tenant while others stay healthy) and ``budget:<int>``
(stop after N injections per site — deterministic "fail exactly once"
tests). With no plan installed every hook is a cheap no-op.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time

import numpy as np

from .errors import InjectedFault

_SITES = ("launch", "compile", "straggler", "poison")


class FaultPlan:
    """A seeded, deterministic fault schedule."""

    def __init__(self, *, launch: float = 0.0, compile: float = 0.0,
                 straggler: float = 0.0, poison: float = 0.0,
                 seed: int = 0, delay_s: float = 0.005,
                 scene=None, budgets: dict | None = None):
        self.rates = {"launch": float(launch), "compile": float(compile),
                      "straggler": float(straggler), "poison": float(poison)}
        for site, rate in self.rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate {site}:{rate} not in [0, 1]")
        self.seed = int(seed)
        self.delay_s = float(delay_s)
        self.scene = scene
        self.budgets = dict(budgets or {})
        self._counts: dict = {s: 0 for s in _SITES}      # decisions taken
        self._fired: dict = {s: 0 for s in _SITES}       # injections fired
        self._lock = threading.Lock()

    # -- decisions ----------------------------------------------------------

    def _uniform(self, site: str, n: int) -> float:
        h = hashlib.sha256(f"{self.seed}:{site}:{n}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def decide(self, site: str, scene=None) -> int | None:
        """One deterministic decision at ``site``; returns the decision
        index when the fault fires, else None. Out-of-scope scenes and
        exhausted budgets never fire (and don't consume a decision for
        scoped-out scenes, so per-scene schedules stay independent of
        other tenants' traffic)."""
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return None
        if self.scene is not None and scene != self.scene:
            return None
        with self._lock:
            n = self._counts[site]
            self._counts[site] = n + 1
            budget = self.budgets.get(site)
            if budget is not None and self._fired[site] >= budget:
                return None
            if self._uniform(site, n) >= rate:
                return None
            self._fired[site] += 1
            return n

    def stats(self) -> dict:
        with self._lock:
            return {"decisions": dict(self._counts),
                    "fired": dict(self._fired)}

    def spec(self) -> str:
        """The plan as a ``REPRO_FAULTS``-style spec string (logging)."""
        parts = [f"{s}:{r:g}" for s, r in self.rates.items() if r > 0]
        parts.append(f"seed:{self.seed}")
        if self.scene is not None:
            parts.append(f"scene:{self.scene}")
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a ``REPRO_FAULTS`` spec string (see module docstring)."""
        kw: dict = {}
        budgets: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(f"REPRO_FAULTS entry {part!r} is not "
                                 f"'key:value'")
            key, val = (s.strip() for s in part.split(":", 1))
            if key in _SITES:
                kw[key] = float(val)
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "delay_ms":
                kw["delay_s"] = float(val) / 1e3
            elif key == "scene":
                kw["scene"] = val
            elif key == "budget":
                for site in _SITES:
                    budgets[site] = int(val)
            else:
                raise ValueError(f"unknown REPRO_FAULTS key {key!r} "
                                 f"(sites: {', '.join(_SITES)}; modifiers: "
                                 f"seed, delay_ms, scene, budget)")
        return cls(**kw, budgets=budgets)


# ---------------------------------------------------------------------------
# process-wide activation
# ---------------------------------------------------------------------------

_PLAN: FaultPlan | None = None
_ENV_READ = False
_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        from .. import obs
        _METRICS = obs.metric_set("faults")
    return _METRICS


def configure(plan: FaultPlan | None = None, *,
              from_env: bool = False) -> FaultPlan | None:
    """Install ``plan`` (None deactivates), or re-read ``REPRO_FAULTS``."""
    global _PLAN, _ENV_READ
    if from_env:
        spec = os.environ.get("REPRO_FAULTS", "")
        _PLAN = FaultPlan.parse(spec) if spec else None
    else:
        _PLAN = plan
    _ENV_READ = True
    return _PLAN


install = configure


def active() -> FaultPlan | None:
    """The installed plan (lazily initialized from ``REPRO_FAULTS``)."""
    if not _ENV_READ:
        configure(from_env=True)
    return _PLAN


class scoped:
    """``with faults.scoped(plan): ...`` — install for a block (tests)."""

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan

    def __enter__(self):
        self._prev, self._prev_read = _PLAN, _ENV_READ
        configure(self.plan)
        return self.plan

    def __exit__(self, *exc):
        global _PLAN, _ENV_READ
        _PLAN, _ENV_READ = self._prev, self._prev_read
        return False


# ---------------------------------------------------------------------------
# the hooks production code calls
# ---------------------------------------------------------------------------

def maybe_fail(site: str, scene=None) -> None:
    """Raise :class:`InjectedFault` when the plan schedules one here."""
    plan = active()
    if plan is None:
        return
    n = plan.decide(site, scene=scene)
    if n is not None:
        _metrics().count(f"injected_{site}")
        raise InjectedFault(site, f"{site}/{scene}" if scene is not None
                            else site, n)


def maybe_delay(scene=None) -> float:
    """Sleep the plan's straggler delay when scheduled; returns the
    injected delay in seconds (0.0 when none fired)."""
    plan = active()
    if plan is None:
        return 0.0
    n = plan.decide("straggler", scene=scene)
    if n is None:
        return 0.0
    _metrics().count("injected_straggler")
    time.sleep(plan.delay_s)
    return plan.delay_s


def maybe_poison(queries: np.ndarray, scene=None) -> np.ndarray:
    """Corrupt one row of ``queries`` with NaN when scheduled (returns a
    poisoned COPY; the caller's array is never mutated)."""
    plan = active()
    if plan is None or queries.size == 0:
        return queries
    n = plan.decide("poison", scene=scene)
    if n is None:
        return queries
    _metrics().count("injected_poison")
    out = np.array(queries, copy=True)
    out[n % out.shape[0]] = np.nan
    return out
