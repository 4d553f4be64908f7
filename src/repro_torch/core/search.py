"""Per-tile window search: the plain tensor path (``use_pallas=False``).

Each query tile gathers, for each query, the (2w+1)^3 cell window around
its own cell from the dense grid, computes squared distances, filters by
the radius (unless the sphere test is skipped) and selects the k nearest.

``REPRO_SELECTION`` picks the selection as in the reference: ``topk``
(partial selection, the default) or ``sort`` (stable full sort). Both keep
the reference's tie order, lower window position first. ``torch.topk``
promises no tie order, so the ``topk`` mode selects on an explicit
(d2, position) key.

``NeighborSearch`` is the eager host-planned surface (paper Listings 1-3):
build the grid, Morton-schedule the queries, partition them by megacell,
bundle the partitions by the cost model, and search each bundle, through
the device-resident ``QueryExecutor`` (``core/executor.py``) or, with
``SearchOpts(executor=False)``, the legacy per-bundle host loop.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..kernels.ref import dot3, topk_select
from . import bundle as bundle_mod
from .partition import (PartitionPlan, compute_megacells, plan_partitions,
                        trivial_plan)
from .schedule import schedule_queries
from .types import (CellGrid, GridSpec, SearchOpts, SearchParams,
                    SearchResult, Tensor, device_table)

_SELECTION = os.environ.get("REPRO_SELECTION", "topk")


def _tile_d2(q: Tensor, cand_pos: Tensor) -> Tensor:
    """[T, 3] x [T, M, 3] -> [T, M] squared distances, expanded form with
    each sum written out x, y, z."""
    qn = dot3(q, q)[:, None]                                 # [T, 1]
    pn = dot3(cand_pos, cand_pos)                            # [T, M]
    cross = dot3(q[:, None, :], cand_pos)                    # [T, M]
    return torch.clamp_min(qn + pn - 2.0 * cross, 0.0)


def _select_topk(d2: Tensor, idx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """k smallest of each row by the key (d2, position): partial selection
    on an int64 key whose high word is d2's bit pattern (monotone for
    non-negative floats and +inf) and whose low word is the position."""
    m = d2.shape[-1]
    kk = min(k, m)
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)     # -0.0 -> +0.0
    pos = torch.arange(m, dtype=torch.int64, device=d2.device)
    _, sel = torch.topk((bits << 32) | pos, kk, dim=-1, largest=False,
                        sorted=True)
    d2k = torch.gather(d2, -1, sel)
    idxk = torch.gather(idx, -1, sel)
    if kk < k:
        pad = (*d2.shape[:-1], k - kk)
        d2k = torch.cat([d2k, d2k.new_full(pad, float("inf"))], dim=-1)
        idxk = torch.cat([idxk, idxk.new_full(pad, -1)], dim=-1)
    idxk = torch.where(torch.isinf(d2k), -1, idxk)
    return d2k, idxk


def window_tile_search(
    grid: CellGrid,
    points: Tensor,
    qt: Tensor,
    spec: GridSpec,
    w: int,
    radius: float,
    k: int,
    skip_test: bool,
    origin: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """One query tile ``qt`` [T, 3] against the (2w+1)^3 window around each
    query's cell: ([T, k] d2, [T, k] idx, [T] cnt)."""
    dev = qt.device
    # per-axis window, clamped to the grid (thin-slab datasets)
    ws = tuple(min(2 * w + 1, d) for d in spec.dims)
    cap = spec.capacity
    _, dy, dz = spec.dims
    r2 = device_table(np.float32(radius) * np.float32(radius),
                      torch.float32, dev)
    lim = device_table([d - s for d, s in zip(spec.dims, ws)], torch.int32,
                       dev)

    ccoord = spec.cell_of(qt, origin)                           # [T, 3]
    start = torch.minimum((ccoord - w).clamp_min(0), lim).to(torch.int64)
    # window cells in (x, y, z) raster order, slots innermost
    ix, iy, iz = torch.meshgrid(
        torch.arange(ws[0], device=dev), torch.arange(ws[1], device=dev),
        torch.arange(ws[2], device=dev), indexing="ij")
    cells = (((start[:, 0, None] + ix.reshape(1, -1)) * dy
              + start[:, 1, None] + iy.reshape(1, -1)) * dz
             + start[:, 2, None] + iz.reshape(1, -1))           # [T, W^3]
    cand = grid.dense.reshape(-1, cap)[cells].reshape(qt.shape[0], -1)
    cand_pos = points[cand.clamp(0, points.shape[0] - 1).long()]
    d2 = _tile_d2(qt, cand_pos)                                 # [T, M]
    invalid = cand < 0
    if not skip_test:
        invalid = invalid | (d2 > r2)
    d2 = torch.where(invalid, float("inf"), d2)
    idx = torch.where(invalid, -1, cand)
    if _SELECTION == "topk":
        d2k, idxk = _select_topk(d2, idx, k)
    else:
        d2k, idxk = topk_select(d2, idx, k)
    cnt = torch.sum(idxk >= 0, dim=-1).to(torch.int32)
    return d2k, idxk, cnt


def _pad_edge(queries: Tensor, n: int) -> Tensor:
    """Edge-replicate ``queries`` [Nq, 3] to ``n`` rows: padded rows repeat
    the last real query, so they search its window instead of distorting
    a tile's shared window."""
    take = torch.clamp_max(torch.arange(n, device=queries.device),
                           queries.shape[0] - 1)
    return queries[take]


def window_search(
    grid: CellGrid,
    points: Tensor,
    queries: Tensor,
    spec: GridSpec,
    w: int,
    radius: float,
    k: int,
    skip_test: bool,
    tile: int = 256,
    origin: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Search each query against the (2w+1)^3 cell window around its cell,
    tile by tile. Returns (idx [Nq,k], d2 [Nq,k], cnt [Nq])."""
    nq = queries.shape[0]
    qp = _pad_edge(queries, nq + (-nq) % tile)
    outs = [window_tile_search(grid, points, qp[s:s + tile], spec, w,
                               radius, k, skip_test, origin)
            for s in range(0, qp.shape[0], tile)]
    d2 = torch.cat([o[0] for o in outs])[:nq]
    idx = torch.cat([o[1] for o in outs])[:nq]
    cnt = torch.cat([o[2] for o in outs])[:nq]
    return idx, d2, cnt


def _pad_bucket(n: int, tile: int) -> int:
    """Next power-of-two multiple of ``tile`` >= n (recompile bounding)."""
    base = max(tile, int(2 ** math.ceil(math.log2(max(n, 1)))))
    return int(math.ceil(base / tile) * tile)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchReport:
    """Execution breakdown mirroring paper Fig. 12 categories, plus the
    executor's dispatch/sync counters."""

    t_build: float = 0.0       # BVH   (grid build)
    t_opt: float = 0.0         # Opt   (schedule + partition + bundle planning)
    t_fs: float = 0.0          # FS    (first-hit pass; closed-form here)
    t_search: float = 0.0      # Search
    bundles: list = dataclasses.field(default_factory=list)
    num_partitions: int = 0
    launches: int = 0          # device dispatches in the last query
    host_syncs: int = 0        # blocking result waits (executor: 1)
    plan_fetches: int = 0      # plan-metadata transfers (executor: <=1)


class NeighborSearch:
    """RTNN-style neighbor search over a fixed point set, on ``device``
    (the card unless the caller passes ``device="cpu"``).

    >>> ns = NeighborSearch(points, SearchParams(radius=0.1, k=8))
    >>> res = ns.query(queries)          # SearchResult in query order
    """

    def __init__(
        self,
        points,
        params: SearchParams,
        opts: SearchOpts = SearchOpts(),
        spec: GridSpec | None = None,
        cost_model: bundle_mod.CostModel | None = None,
        device="cuda",
    ):
        from .api import build_index
        from .executor import QueryExecutor
        self.params = params
        self.opts = opts
        self.cost_model = cost_model or bundle_mod.CostModel()
        # the structure is a NeighborIndex of the functional core; the
        # executor is the host-planned path over the same tensors
        self.index = build_index(points, params, opts, spec=spec,
                                 device=device)
        self.spec = self.index.spec
        self.points = self.index.points
        self.grid = self.index.grid
        self.statics = self.index.statics
        self.device = self.index.device
        self.report = SearchReport()
        self.executor = QueryExecutor(self)

    # -- pipeline stages ----------------------------------------------------

    def _queries(self, queries) -> Tensor:
        from .api import _as_points
        return _as_points(queries, self.device)

    def _schedule(self, queries: Tensor) -> tuple[Tensor, Tensor]:
        if not self.opts.schedule:
            eye = torch.arange(queries.shape[0], dtype=torch.int32,
                               device=queries.device)
            return eye, eye
        return schedule_queries(self.spec, queries)

    def _partition(self, queries_s: Tensor) -> PartitionPlan:
        nq = queries_s.shape[0]
        if not self.opts.partition or not self.statics.has_megacells:
            return trivial_plan(nq, self.statics.w_full)
        w_search, skip, rho = compute_megacells(
            self.grid, queries_s, self.statics, self.params)
        return plan_partitions(w_search, skip, rho, self.statics.w_full)

    def _bundle(self, plan: PartitionPlan) -> list[bundle_mod.Bundle]:
        return bundle_mod.plan_bundles(
            plan.partitions, self.cost_model,
            n_points=int(self.points.shape[0]),
            cell_size=self.spec.cell_size,
            mode=self.params.mode, k=self.params.k,
            w_sph=self.statics.w_sph,
            enable=self.opts.bundle,
        )

    # -- execution ----------------------------------------------------------

    def query(self, queries) -> SearchResult:
        """Search ``queries`` [Nq, 3]; results come back in query order.

        The default path is the device-resident ``QueryExecutor``
        (signature-batched launches, on-device scatter, one blocking wait);
        ``SearchOpts(executor=False)`` keeps the legacy per-bundle host loop
        for A/B timing.
        """
        if self.opts.executor:
            return self.executor.execute(queries)
        return self._query_host_loop(queries)

    def _query_host_loop(self, queries) -> SearchResult:
        queries = self._queries(queries)
        nq = queries.shape[0]
        k = self.params.k

        t0 = time.perf_counter()
        perm, _inv = self._schedule(queries)
        queries_s = queries[perm.long()]
        plan = self._partition(queries_s)
        bundles = self._bundle(plan)
        self.report.t_opt = time.perf_counter() - t0
        self.report.num_partitions = plan.num_partitions
        self.report.bundles = bundles

        out_idx = np.full((nq, k), -1, np.int32)
        out_d2 = np.full((nq, k), np.inf, np.float32)
        out_cnt = np.zeros((nq,), np.int32)
        perm_np = perm.cpu().numpy()

        t0 = time.perf_counter()
        searcher = self._searcher()
        for b in bundles:
            sel_sched = bundle_mod.bundle_query_sel(plan, b)
            qb = queries_s[torch.as_tensor(sel_sched).to(self.device)]
            pad_n = _pad_bucket(qb.shape[0], self.opts.query_tile)
            # edge-replicate padding: padded rows are copies of a real query
            # so the fused path's tile window anchors are not distorted
            qb = _pad_edge(qb, pad_n)
            idx, d2, cnt = searcher(
                self.grid, self.points, qb, self.spec,
                int(b.w_search), self.params.radius, k,
                bool(b.skip_test), self.opts.query_tile)
            n_b = sel_sched.shape[0]
            orig = perm_np[sel_sched]
            out_idx[orig] = idx.cpu().numpy()[:n_b]
            out_d2[orig] = d2.cpu().numpy()[:n_b]
            out_cnt[orig] = cnt.cpu().numpy()[:n_b]
        self.report.t_search = time.perf_counter() - t0
        self.report.launches = len(bundles)
        # per bundle: 3 blocking result transfers; +1 for the perm fetch
        self.report.host_syncs = 3 * len(bundles) + 1
        self.report.plan_fetches = 3 if (self.opts.partition and
                                         self.statics.has_megacells) else 0

        dev = self.device
        return SearchResult(indices=torch.from_numpy(out_idx).to(dev),
                            distances2=torch.from_numpy(out_d2).to(dev),
                            counts=torch.from_numpy(out_cnt).to(dev))

    def _searcher(self):
        # both searchers take the same positional arguments and return
        # (idx, d2, cnt); the fused one launches the hand-written kernel
        if self.opts.use_pallas:
            from ..kernels.ops import window_search_pallas
            return window_search_pallas
        return window_search


def neighbor_search(points, queries, radius: float, k: int,
                    mode: str = "knn",
                    opts: SearchOpts = SearchOpts(),
                    knn_window: str = "exact",
                    device="cuda") -> SearchResult:
    """One-shot search (builds the structure and searches), through the
    keyed searcher cache of the functional core (``api.cached_searcher``):
    repeated one-shot calls over the same point set reuse the built grid
    and every plan cache."""
    from .api import cached_searcher
    params = SearchParams(radius=radius, k=k, mode=mode,
                          knn_window=knn_window)
    return cached_searcher(points, params, opts, device=device).query(
        queries)
