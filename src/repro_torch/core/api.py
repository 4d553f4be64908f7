"""Functional core: ``build_index`` / ``plan_query`` / ``execute_plan`` /
``query`` on tensors.

The pipeline of the reference's ``core/api.py`` in eager PyTorch. The
queries are scheduled by (launch-signature level, Morton code), padded to a
tile multiple, and searched tile by tile, either by the fused kernel path
(``use_pallas=True``: ``kernels/ops.window_search_segmented``, one launch
of the hand-written kernel over every tile) or by the plain per-tile path
(``core/search.window_tile_search``). On CUDA, ``plan_query`` followed by a
fused ``execute_plan`` makes no host synchronisation.

Every entry point runs on the card unless the caller asks otherwise: the
``device`` of :func:`build_index` defaults to ``"cuda"`` and every later
tensor follows ``index.points.device``. ``update_index`` re-bins moved
points into the index's frozen spec (the dynamic session's first stage).
``cached_searcher`` keeps the host-planned ``NeighborSearch`` objects of
the one-shot ``neighbor_search`` by a fingerprint of their inputs.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os

import numpy as np
import torch
from torch.profiler import record_function

from ..reliability.errors import QueryError
from .grid import (build_cell_grid, choose_grid_spec, parked_mask,
                   update_cell_grid)
from .partition import (MegacellStatics, compute_megacells, launch_signatures,
                        megacell_statics, signature_levels)
from .schedule import schedule_by_level
from .search import window_tile_search
from .types import (PARK_THRESHOLD, CellGrid, GridSpec, SearchOpts,
                    SearchParams, SearchResult, Tensor, UpdateStats)


@dataclasses.dataclass
class NeighborIndex:
    """The built search structure: static ``params``, ``opts``, ``statics``;
    tensors ``points`` [N, 3], the ``grid``, ``anchor_points`` (the
    positions the current plan was captured at) and ``origin``, an optional
    [3] override of the spec origin (None = ``spec.origin``)."""

    params: SearchParams
    opts: SearchOpts
    statics: MegacellStatics
    points: Tensor
    grid: CellGrid
    anchor_points: Tensor
    origin: Tensor | None = None

    @property
    def spec(self) -> GridSpec:
        return self.grid.spec

    @property
    def device(self) -> torch.device:
        return self.points.device

    def with_anchor(self, anchor_points: Tensor) -> "NeighborIndex":
        return dataclasses.replace(self, anchor_points=anchor_points)


@dataclasses.dataclass
class QueryPlan:
    """A replayable schedule + partition plan.

    ``nq``, ``tile`` and the launch-signature ``ladder`` are static;
    ``perm`` [Np] i32 is the (level, Morton) permutation edge-padded to a
    tile multiple (padded slots repeat the last scheduled query) and
    ``tile_levels`` [Np // tile] i32 each tile's ladder level.
    """

    nq: int
    tile: int
    ladder: tuple
    perm: Tensor
    tile_levels: Tensor


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no CUDA device, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port's plain CPU path")
    return dev


def _as_points(x, device) -> Tensor:
    """``x`` as float32 [.., 3] on ``device``; a host array is uploaded
    without a host synchronisation (pageable memory is staged)."""
    t = torch.as_tensor(np.asarray(x, np.float32)) if not isinstance(
        x, torch.Tensor) else x
    return t.to(device=device, dtype=torch.float32, non_blocking=True)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def build_index(points, params: SearchParams,
                opts: SearchOpts = SearchOpts(), *,
                spec: GridSpec | None = None,
                origin=None, device="cuda") -> NeighborIndex:
    """Build a :class:`NeighborIndex` over ``points`` [N, 3] on ``device``.

    Without a ``spec`` the grid parameters are planned on the host from the
    points (``choose_grid_spec``). ``origin`` [3] overrides ``spec.origin``
    for every cell lookup. With ``opts.mask_parked`` rows parked at the
    padding sentinel are left out of the grid.
    """
    dev = resolve_device(device)
    if spec is None:
        host = (points.detach().cpu().numpy() if isinstance(
            points, torch.Tensor) else np.asarray(points, np.float32))
        spec = choose_grid_spec(host, params.radius)
    with record_function("repro.build_index"):
        points = _as_points(points, dev)
        if origin is not None:
            origin = _as_points(origin, dev)
        valid = torch.logical_not(parked_mask(points)) if opts.mask_parked \
            else None
        grid = build_cell_grid(points, spec, origin, valid)
        statics = megacell_statics(spec.cell_size, params, opts.w_max)
        return NeighborIndex(params=params, opts=opts, statics=statics,
                             points=points, grid=grid, anchor_points=points,
                             origin=origin)


def update_index(index: NeighborIndex, new_points, *,
                 donate: bool = False) -> tuple[NeighborIndex, UpdateStats]:
    """Re-bin moved points into the index's frozen spec.

    Returns the updated index and its :class:`UpdateStats` as 0-d tensors
    on the index's device, with no host synchronisation: ``overflow`` and
    ``oob`` (nonzero means the frozen spec can no longer hold the scene
    exactly) and ``max_disp2`` against ``anchor_points`` (the staleness
    statistic). The anchor is not advanced: re-anchoring after a replan is
    the caller's job (``with_anchor``). ``donate=True`` writes the new dense
    grid into the old one's storage (``update_cell_grid``), so ``index``
    must not be searched afterwards; the points are never written.
    """
    with record_function("repro.update_index"):
        pts = _as_points(new_points, index.device)
        grid, stats, _ccoord = update_cell_grid(
            index.grid, pts, index.anchor_points,
            use_pallas=index.opts.use_pallas, donate=donate,
            origin=index.origin, mask_parked=index.opts.mask_parked)
        return dataclasses.replace(index, points=pts, grid=grid), stats


# ---------------------------------------------------------------------------
# plan / execute / query
# ---------------------------------------------------------------------------

def plan_query(index: NeighborIndex, queries, *,
               margin: int = 0) -> QueryPlan:
    """Schedule + partition ``queries`` into a replayable
    :class:`QueryPlan`.

    ``margin`` inflates every window by that many cells (clamped to the
    full-radius window) and revokes the sphere-test skip for any window
    pushed past the inscribed ring.
    """
    with record_function("repro.plan_query"):
        queries = _as_points(queries, index.device)
        params, opts, statics = index.params, index.opts, index.statics
        spec = index.spec
        nq = queries.shape[0]
        tile = opts.query_tile
        partitioned = opts.partition and statics.has_megacells
        ladder = launch_signatures(statics, params, margin=margin,
                                   enabled=partitioned,
                                   w_ladder=opts.w_ladder)
        ccoord = spec.cell_of(queries, index.origin)
        if partitioned:
            w_search, skip, _rho = compute_megacells(index.grid, queries,
                                                     statics, params,
                                                     index.origin)
            if margin:
                w_search = torch.clamp_max(w_search + margin,
                                           statics.w_full)
                skip = skip & (w_search <= statics.w_sph)
            levels = signature_levels(w_search, skip, ladder)
        else:
            levels = torch.zeros((nq,), dtype=torch.int32,
                                 device=index.device)
        perm = schedule_by_level(ccoord, levels, morton=opts.schedule)
        npad = (-nq) % tile
        # edge-replicate padding: padded slots repeat the last scheduled
        # query
        take = torch.clamp_max(torch.arange(nq + npad, device=index.device),
                               nq - 1)
        perm_p = perm[take]
        tile_levels = levels[perm_p.long()].reshape(-1, tile).max(
            dim=1).values.to(torch.int32)
        return QueryPlan(nq=nq, tile=tile, ladder=ladder, perm=perm_p,
                         tile_levels=tile_levels)


def execute_plan(index: NeighborIndex, queries,
                 plan: QueryPlan) -> SearchResult:
    """Run ``queries`` through a captured plan; results in query order.

    Fused path (``SearchOpts(use_pallas=True)``): one kernel launch over
    the plan's (level, Morton)-ordered tiles, no host synchronisation.
    Plain path: each tile runs ``window_tile_search`` at its level's window;
    it reads the tile levels on the host once (one synchronisation).
    """
    with record_function("repro.execute_plan"):
        return _execute_plan_scoped(index, queries, plan)


def _execute_plan_scoped(index, queries, plan):
    queries = _as_points(queries, index.device)
    params = index.params
    k, tile, nq = params.k, plan.tile, plan.nq
    grid, points, spec = index.grid, index.points, index.spec
    perm = plan.perm.long()
    qs = queries[perm]

    if index.opts.use_pallas:
        from ..kernels.ops import window_search_segmented
        d2t, idxt, cntt = window_search_segmented(
            grid, points, qs, spec, plan.ladder, plan.tile_levels,
            params.radius, k, tile, origin=index.origin)
    else:
        n_ladder = len(plan.ladder)
        outs = []
        for i, lvl in enumerate(plan.tile_levels.tolist()):
            w, skip = plan.ladder[min(max(lvl, 0), n_ladder - 1)]
            outs.append(window_tile_search(
                grid, points, qs[i * tile:(i + 1) * tile], spec, w,
                params.radius, k, skip, origin=index.origin))
        d2t = torch.cat([o[0] for o in outs])
        idxt = torch.cat([o[1] for o in outs])
        cntt = torch.cat([o[2] for o in outs])
    # Only the edge-padded last tile writes some rows twice, and its padded
    # rows repeat the last real query's row exactly, so the unordered
    # duplicate writes of CUDA index_put_ all store the same values.
    dev = index.device
    out_idx = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    out_d2 = torch.full((nq, k), float("inf"), dtype=torch.float32,
                        device=dev)
    out_cnt = torch.zeros((nq,), dtype=torch.int32, device=dev)
    out_idx[perm] = idxt
    out_d2[perm] = d2t
    out_cnt[perm] = cntt
    return SearchResult(indices=out_idx, distances2=out_d2, counts=out_cnt)


def _validate_enabled() -> bool:
    """`REPRO_VALIDATE=1` validates host-side query inputs inside
    ``query``. Read per call, not at import."""
    return os.environ.get("REPRO_VALIDATE", "0") not in ("", "0")


def validate_queries(queries, *, lo=None, hi=None, max_rows: int = 8):
    """Reject unservable host query inputs with a structured
    :class:`QueryError`: NaN, inf, and out-of-domain rows (magnitude at the
    parked-row threshold, or outside explicit ``lo``/``hi`` bounds).
    Tensors pass through unfetched, so validation adds no device
    synchronisation. Returns ``queries`` unchanged when clean."""
    if isinstance(queries, torch.Tensor):
        return queries
    q = np.asarray(queries, np.float32)
    nan = np.isnan(q).any(axis=-1)
    inf = np.isinf(q).any(axis=-1)
    finite = ~(nan | inf)
    oob = finite & (np.abs(q) >= PARK_THRESHOLD).any(axis=-1)
    if lo is not None:
        oob |= finite & (q < np.asarray(lo, np.float32)).any(axis=-1)
    if hi is not None:
        oob |= finite & (q > np.asarray(hi, np.float32)).any(axis=-1)
    bad = nan | inf | oob
    if bad.any():
        reasons = {}
        for name, mask in (("nan", nan), ("inf", inf), ("oob", oob)):
            n = int(mask.sum())
            if n:
                reasons[name] = n
        rows = np.flatnonzero(bad.reshape(-1))[:max_rows].tolist()
        raise QueryError(reasons, rows, int(np.prod(bad.shape)))
    return queries


def query(index: NeighborIndex, queries) -> SearchResult:
    """Neighbor search: ``execute_plan(plan_query(...))``. Results are in
    query order and exact (knn distances and counts; range mode returns a
    bounded in-radius subset). With ``REPRO_VALIDATE=1`` host-side queries
    are validated first."""
    if _validate_enabled():
        queries = validate_queries(queries)
    queries = _as_points(queries, index.device)
    return execute_plan(index, queries, plan_query(index, queries))


def query_concat(index: NeighborIndex, queries_list) -> list[SearchResult]:
    """Many requests' queries against one index as ONE plan + execute,
    split back per request (each row's result depends only on its own
    query, so it equals what ``query`` returns for that request alone)."""
    sizes = [q.shape[0] for q in queries_list]
    if not sizes:
        return []
    cat = torch.cat([_as_points(q, index.device) for q in queries_list])
    res = query(index, cat)
    out, off = [], 0
    for n in sizes:
        out.append(SearchResult(indices=res.indices[off:off + n],
                                distances2=res.distances2[off:off + n],
                                counts=res.counts[off:off + n]))
        off += n
    return out


# ---------------------------------------------------------------------------
# keyed searcher cache (one-shot surface)
# ---------------------------------------------------------------------------

_SEARCHER_CACHE: collections.OrderedDict = collections.OrderedDict()
_SEARCHER_CACHE_MAX = 8


def cached_searcher(points, params: SearchParams,
                    opts: SearchOpts = SearchOpts(), *, device="cuda"):
    """Keyed cache behind the one-shot ``neighbor_search``.

    The searcher is cached by a value fingerprint of (points, params,
    opts, device), so repeated one-shot calls over the same point set
    reuse the built grid and the executor's plan and launcher caches.
    LRU-bounded at ``_SEARCHER_CACHE_MAX``; the entries hold their grids on
    the device until evicted, so memory-sensitive callers should use
    :func:`searcher_cache_clear` or build a ``NeighborSearch`` directly.
    """
    from .search import NeighborSearch
    dev = resolve_device(device)
    pts_np = (points.detach().cpu().numpy() if isinstance(
        points, torch.Tensor) else np.asarray(points, np.float32))
    pts_np = np.ascontiguousarray(pts_np, np.float32)
    digest = hashlib.sha1(pts_np.tobytes()).digest()
    key = (pts_np.shape, digest, params, opts, dev)
    hit = _SEARCHER_CACHE.get(key)
    if hit is not None:
        _SEARCHER_CACHE.move_to_end(key)
        return hit
    ns = NeighborSearch(pts_np, params, opts, device=dev)
    _SEARCHER_CACHE[key] = ns
    if len(_SEARCHER_CACHE) > _SEARCHER_CACHE_MAX:
        _SEARCHER_CACHE.popitem(last=False)
    return ns


def searcher_cache_stats() -> dict:
    """Size of the one-shot searcher cache."""
    return {"entries": len(_SEARCHER_CACHE),
            "max_entries": _SEARCHER_CACHE_MAX}


def searcher_cache_clear() -> None:
    _SEARCHER_CACHE.clear()


__all__ = [
    "GridSpec",
    "NeighborIndex",
    "QueryError",
    "QueryPlan",
    "SearchOpts",
    "SearchParams",
    "SearchResult",
    "UpdateStats",
    "build_index",
    "cached_searcher",
    "execute_plan",
    "launch_signatures",
    "plan_query",
    "query",
    "query_concat",
    "searcher_cache_clear",
    "searcher_cache_stats",
    "update_index",
    "validate_queries",
]
