"""Dynamic-scene sessions: persistent neighbor search over moving points.

The reference's ``core/dynamic.py`` in eager PyTorch. RTNN's target
applications (SPH fluids, MD, point-cloud registration) are
frame-stepped: points move a little each step. :class:`SimulationSession`
keeps the index resident across steps:

* **frozen spec**: the ``GridSpec`` is planned once, with domain margin
  and capacity slack so points can drift, and every step re-bins into it
  (``api.update_index``, the hand-written kernel ``bin_disp_tile`` with
  ``SearchOpts(use_pallas=True)``);
* **one blocking transfer per step**: the update's counters and the
  staleness decision are packed on the device into one small int32
  vector (``obs.pack_step_telemetry``: flags, overflow, oob, displacement
  bits), and fetching it is the step's only host synchronisation;
* **host branch on that fetch**: where the reference runs
  ``lax.cond(stale, replan, replay)`` on the device, the port branches on
  the fetched flags: respec, replan (``api.plan_query`` with the
  ``reuse_margin_cells`` inflation, then re-anchor), or replay the
  captured plan. ``api.execute_plan`` then launches with no further sync,
  so on CUDA ``step`` returns with the search still in flight;
* **respec fallback**: a nonzero overflow or out-of-bounds count means the
  frozen grid can no longer hold the scene exactly; the session re-plans
  the spec on the host (a second transfer: the points), rebuilds, and
  searches once on the new index. The reference searches, detects and
  searches again; results and the ``StepReport`` (the pre-respec
  counters) are the same. Respecs carry the reference's hysteresis
  (``SessionOpts.respec_growth``);
* **self-query**: ``step(points)`` uses one device buffer for points and
  queries;
* **step lock**: ``step`` holds ``sess.lock`` from before its first device
  write through the swap of ``sess.index``. A reader that launches work on
  ``sess.index`` from another thread (the serve pump) holds it through its
  last launch, so, in stream order, its launches read one whole frame even
  while a donated re-bin writes the next frame into the same storage.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np
import torch

from .. import obs
from ..kernels.ref import sq_dist
from . import api
from .grid import choose_grid_spec
from .types import (GridSpec, SearchOpts, SearchParams, SearchResult,
                    device_table)


@dataclasses.dataclass(frozen=True)
class SessionOpts:
    """Static knobs of a :class:`SimulationSession` (the reference's fields).

    ``displacement_frac``  staleness threshold as a fraction of cell size:
                           the cached plan is replayed while the max
                           displacement since its capture stays below
                           ``displacement_frac * cell_size``. Must be
                           <= 0.5 for the ``reuse_margin_cells`` default to
                           keep reused plans exact.
    ``reuse_margin_cells`` window inflation baked into captured plans: 2
                           cells absorb candidate drift + the query's own
                           cell shift at the default threshold.
    ``capacity_slack``     cell-capacity headroom of the frozen spec.
    ``domain_margin_radii`` bounding-box padding of the frozen spec, in
                           search radii per side; escapes respec.
    ``auto_respec``        respec-and-rebuild when overflow/out-of-bounds
                           is detected (False: raise instead).
    ``respec_growth``      respec hysteresis: every respec multiplies the
                           new spec's capacity slack AND domain margin by
                           ``respec_growth ** respecs_so_far``, so an
                           adversarial workload triggers O(log frames)
                           respecs. 1.0 disables it.
    ``respec_boost_max``   cap on the accumulated hysteresis multiplier
                           (capacity scales the dense grid's memory).
    ``donate_grid``        re-bin each step into the storage of the
                           previous dense grid (``update_cell_grid``'s
                           ``donate``), so two dense grids are never live
                           at once. Only the session-owned grid is
                           written; the points, which may be the caller's
                           tensor, never are. None = on off the CPU. After
                           a step the previous index's dense grid holds
                           the new one: re-read ``sess.index``.
    """

    displacement_frac: float = 0.45
    reuse_margin_cells: int = 2
    capacity_slack: float = 1.5
    domain_margin_radii: float = 1.0
    max_dim: int = 256
    auto_respec: bool = True
    respec_growth: float = 2.0
    respec_boost_max: float = 64.0
    donate_grid: bool | None = None


@dataclasses.dataclass
class StepReport:
    """Per-step breakdown. ``max_disp`` / ``overflow`` / ``oob`` come from
    the packed telemetry vector, at no extra sync. Times are host clock:
    ``t_update`` is ``update_index`` up to the fetched vector, ``t_plan``
    the replan's ``plan_query`` (0.0 on a replay), ``t_search`` the whole
    step (on CUDA the search is still running when ``step`` returns)."""

    t_update: float = 0.0
    t_plan: float = 0.0
    t_search: float = 0.0
    fast: bool = False         # replayed the captured plan
    replanned: bool = False
    respecced: bool = False
    max_disp: float = 0.0
    overflow: int = 0
    oob: int = 0


def validate_session_opts(sopts: SessionOpts) -> None:
    """The staleness-contract invariant: each of the query and its
    candidates may shift ceil(frac) cells before a replan, so the baked-in
    window margin must cover both or plan reuse silently loses
    exactness."""
    if sopts.displacement_frac <= 0.0:
        raise ValueError("displacement_frac must be > 0")
    need = 2 * math.ceil(sopts.displacement_frac)
    if sopts.reuse_margin_cells < need:
        raise ValueError(
            f"reuse_margin_cells={sopts.reuse_margin_cells} cannot keep "
            f"reused plans exact at displacement_frac="
            f"{sopts.displacement_frac} (needs >= {need})")


def session_grid_spec(points: np.ndarray, radius: float,
                      sopts: SessionOpts = SessionOpts(),
                      boost: float = 1.0) -> GridSpec:
    """Host-side planning of a session's *frozen* grid: the static policy
    of ``choose_grid_spec`` plus drift headroom (domain margin, capacity
    slack), both scaled by the respec-hysteresis ``boost``."""
    return choose_grid_spec(
        np.asarray(points, np.float32), radius,
        max_dim=sopts.max_dim,
        capacity_slack=sopts.capacity_slack * boost,
        domain_margin=sopts.domain_margin_radii * float(radius) * boost,
    )


# flags bitmask in slot 0 of the packed telemetry vector
_FLAG_REPLANNED = 1     # stale (or forced): replan instead of replay
_FLAG_EXHAUSTED = 2     # overflow/oob: frozen spec can no longer bin exactly


def _host_points(points) -> np.ndarray:
    if isinstance(points, torch.Tensor):
        return points.detach().cpu().numpy()
    return np.asarray(points, np.float32)


class SimulationSession:
    """Persistent neighbor search over a frame-stepped scene.

    >>> sess = SimulationSession(points, SearchParams(radius=0.1, k=8))
    >>> for _ in range(steps):
    ...     res = sess.step(points)          # self-query (SPH/MD)
    ...     points = integrate(points, res)

    ``step(points, queries)`` searches external queries instead; both forms
    return a ``SearchResult`` in query order, exact for the *current*
    positions, including across respecs. The session runs on ``device``
    ("cuda" unless the caller asks for the CPU). ``stats()`` gives the
    reference's lifecycle counters (steps / fast_steps / replans / respecs
    / stats_fetches / host_syncs / level_occ_*); the reference's
    ``step_cache_size`` counts jit variants and has no counterpart in
    eager PyTorch, so it is left out.
    """

    def __init__(
        self,
        points,
        params: SearchParams,
        opts: SearchOpts = SearchOpts(),
        sopts: SessionOpts = SessionOpts(),
        spec: GridSpec | None = None,
        *,
        device="cuda",
    ):
        validate_session_opts(sopts)
        dev = api.resolve_device(device)
        spec = spec or session_grid_spec(_host_points(points), params.radius,
                                         sopts)
        self._setup(api.build_index(points, params, opts, spec=spec,
                                    device=dev), sopts)

    @classmethod
    def from_state(cls, index: api.NeighborIndex,
                   sopts: SessionOpts = SessionOpts(), *,
                   plan: api.QueryPlan | None = None,
                   anchor_queries=None) -> "SimulationSession":
        """A session resumed at a given state: ``index`` (its
        ``anchor_points`` are the positions ``plan`` was captured at), the
        captured ``plan`` (None: the next step plans afresh) and, in
        external-query mode, the queries the plan was captured at
        (``convert.session_from_arrays`` carries these across)."""
        validate_session_opts(sopts)
        sess = cls.__new__(cls)
        sess._setup(index, sopts, plan, anchor_queries)
        return sess

    def _setup(self, index, sopts, plan=None, anchor_queries=None):
        self.sopts = sopts
        self.lock = threading.Lock()
        self._index = index
        self._plan = plan
        self._anchor_queries = anchor_queries
        donate = sopts.donate_grid
        if donate is None:
            donate = index.device.type != "cpu"
        self._donate = bool(donate)
        # a fresh plan's tile histogram travels to the host behind an event
        # and is counted once it has landed (_fold_occupancy); the current
        # plan's histogram on the host, counted again on every replay
        self._pending_occ = None
        self._plan_occ = (None if plan is None else obs.level_occupancy(
            plan.tile_levels, len(plan.ladder)).tolist())
        self._metrics = obs.metric_set("session")
        self.report = StepReport()

    # -- surface ------------------------------------------------------------

    @property
    def spec(self) -> GridSpec:
        return self._index.spec

    @property
    def params(self) -> SearchParams:
        return self._index.params

    @property
    def index(self) -> api.NeighborIndex:
        """The session-managed functional index (``core/api.py``)."""
        return self._index

    def stats(self) -> dict:
        self._fold_occupancy(wait=True)
        counters = dict(steps=0, fast_steps=0, replans=0, respecs=0,
                        stats_fetches=0, host_syncs=0)
        counters.update(self._metrics.counters())
        return {**counters, "last": dataclasses.asdict(self.report)}

    # -- telemetry ----------------------------------------------------------

    def _pack(self, index, stats, q, anchor_q, force, self_query):
        """Flags and counters of this step as one int32 vector on the
        device; no sync."""
        disp2 = stats.max_disp2
        if not self_query:
            disp2 = torch.maximum(disp2, torch.max(sq_dist(q, anchor_q)))
        bad = (stats.overflow > 0) | (stats.oob > 0)
        if force:
            stale = torch.ones((), dtype=torch.bool, device=index.device)
        else:
            thr2 = (self.sopts.displacement_frac * index.spec.cell_size) ** 2
            stale = disp2 > device_table(np.float32(thr2), torch.float32,
                                         index.device)
        flags = (stale.to(torch.int32) * _FLAG_REPLANNED
                 + bad.to(torch.int32) * _FLAG_EXHAUSTED)
        return obs.pack_step_telemetry(flags, overflow=stats.overflow,
                                       oob=stats.oob, max_disp2=disp2)

    def _stage_occupancy(self, plan) -> None:
        """Start the copy of a fresh plan's tile histogram to the host: into
        pinned memory, non-blocking, behind an event, so it adds no sync."""
        hist = obs.level_occupancy(plan.tile_levels, len(plan.ladder))
        event = None
        if hist.device.type == "cuda":
            host = torch.empty(hist.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(hist, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(hist.device))
            hist = host
        self._pending_occ = (event, hist)

    def _fold_occupancy(self, wait: bool = False) -> None:
        """Count a staged histogram into ``level_occ_*`` once its copy has
        landed. After a step's fetch it has (the fetch waited for the
        stream), so the event query is no sync; ``stats()`` waits."""
        if self._pending_occ is None:
            return
        event, host = self._pending_occ
        if event is not None and not event.query():
            if not wait:
                return
            event.synchronize()
        self._pending_occ = None
        self._plan_occ = host.tolist()
        self._count_occupancy(self._plan_occ)

    def _count_occupancy(self, occ) -> None:
        for lvl, n in enumerate(occ):
            self._metrics.count(f"level_occ_{lvl}", n)

    # -- lifecycle ----------------------------------------------------------

    def _respec(self, pts, index) -> api.NeighborIndex:
        """Host re-plan of the frozen spec with hysteresis, and a fresh
        index. Reading the points on the host is this rare path's second
        blocking transfer."""
        respecs = self._metrics.count("respecs")
        boost = min(float(self.sopts.respec_growth) ** int(respecs),
                    float(self.sopts.respec_boost_max))
        host = pts.cpu().numpy()
        self._metrics.count("host_syncs")
        spec = session_grid_spec(host, index.params.radius, self.sopts,
                                 boost=boost)
        # a fresh spec covers every point and sizes capacity from the data,
        # so the new index is clean by construction
        return api.build_index(pts, index.params, index.opts, spec=spec,
                               device=pts.device)

    def step(self, points, queries=None) -> SearchResult:
        """Advance the session to ``points`` and search.

        ``queries=None`` (or ``queries is points``) is the self-query path:
        every particle queries its own neighborhood over one device buffer.
        Results are in query order, exact for the current positions. The
        packed telemetry fetch is the step's one blocking transfer (two on
        a respec step). The whole step holds ``self.lock``. The caller may
        move its tensors in place between steps (``pos += vel * dt``): a
        replan snapshots the positions it anchors the plan at, so the
        staleness statistic still sees the move.
        """
        rep = StepReport()
        m = self._metrics
        with self.lock, obs.span("step") as sp_step:
            dev = self._index.device
            self_query = queries is None or queries is points
            pts = api._as_points(points, dev)
            q = pts if self_query else api._as_points(queries, dev)

            with obs.span("plan"):
                index = self._index
                if pts.shape != index.points.shape:
                    # particle count changed under the frozen spec: re-seat
                    # the points; the displacement statistic restarts here
                    index = dataclasses.replace(index, points=pts,
                                                anchor_points=pts)
                    self._plan = None
                anchor_q = self._anchor_queries
                # switching between self-query and external queries always
                # replans: the captured plan is anchored at the other set's
                # positions, which the displacement statistic does not track
                force = (self._plan is None
                         or self._plan.nq != q.shape[0]
                         or self_query != (anchor_q is None))
                if self_query:
                    anchor_q = q
                elif anchor_q is None or anchor_q.shape != q.shape:
                    anchor_q = q
                    force = True

            t0 = time.perf_counter()
            with obs.span("launch", forced=bool(force)):
                index2, stats = api.update_index(index, pts,
                                                 donate=self._donate)
                telem = self._pack(index2, stats, q, anchor_q, force,
                                   self_query)
            with obs.span("sync"):
                tel = obs.unpack_step_telemetry(telem.cpu().numpy())
            m.count("host_syncs")
            self._fold_occupancy()
            rep.t_update = time.perf_counter() - t0
            fl = tel["flags"]
            rep.overflow, rep.oob = tel["overflow"], tel["oob"]
            rep.max_disp = math.sqrt(max(tel["max_disp2"], 0.0))

            if fl & _FLAG_EXHAUSTED:
                if not self.sopts.auto_respec:
                    # keep the session consistent (updated grid, dropped
                    # plan) before raising
                    stale = bool(fl & _FLAG_REPLANNED)
                    self._index = index2.with_anchor(
                        pts.clone() if stale else index2.anchor_points)
                    self._plan = None
                    self._anchor_queries = (None if self_query else
                                            q.clone() if stale else anchor_q)
                    raise RuntimeError(
                        f"frozen grid exhausted (overflow={rep.overflow}, "
                        f"out_of_bounds={rep.oob}) and auto_respec is "
                        f"disabled")
                index2 = self._respec(pts, index)
                rep.respecced = True
                # the fresh index's own counters, as the reference's second
                # pass reports them: a forced replan with nothing escaped
                tel = dict(tel, flags=_FLAG_REPLANNED, overflow=0, oob=0,
                           max_disp2=0.0)
                fl = _FLAG_REPLANNED

            with obs.span("launch", stage="search"):
                if fl & _FLAG_REPLANNED:
                    t1 = time.perf_counter()
                    plan = api.plan_query(
                        index2, q, margin=int(self.sopts.reuse_margin_cells))
                    rep.t_plan = time.perf_counter() - t1
                    # the anchors are snapshots: a caller that moves its
                    # own tensor in place must not move them as well
                    index3 = index2.with_anchor(pts.clone())
                    anchor_q2 = None if self_query else q.clone()
                    self._stage_occupancy(plan)
                else:
                    plan, index3, anchor_q2 = self._plan, index2, anchor_q
                    self._count_occupancy(self._plan_occ)
                res = api.execute_plan(index3, q, plan)

            self._index = index3
            self._plan = plan
            self._anchor_queries = None if self_query else anchor_q2
            if fl & _FLAG_REPLANNED:
                rep.replanned = True
                m.count("replans")
            else:
                rep.fast = True
                m.count("fast_steps")
            m.count("steps")
            m.count("overflow_points", tel["overflow"])
            m.count("oob_points", tel["oob"])
            m.gauge("staleness_disp2", tel["max_disp2"])
        rep.t_search = sp_step.duration
        m.observe("step_s", rep.t_search)
        self.report = rep
        return res
