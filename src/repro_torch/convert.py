"""Carry a built index and a captured plan into the port.

The state of this system is its built grid and its captured query plan.
These functions take that state as numpy arrays and plain values (the
static spec, params and options as dataclasses or as the ``dict`` that
``dataclasses.asdict`` makes of the reference's ones), so that
``execute_plan`` can run under exactly the index and plan that another
implementation built.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import NeighborIndex, QueryPlan, resolve_device
from .core.partition import megacell_statics
from .core.types import CellGrid, GridSpec, SearchOpts, SearchParams


def _spec(spec) -> GridSpec:
    if isinstance(spec, GridSpec):
        return spec
    return GridSpec(origin=tuple(float(o) for o in spec["origin"]),
                    cell_size=float(spec["cell_size"]),
                    dims=tuple(int(d) for d in spec["dims"]),
                    capacity=int(spec["capacity"]))


def _params(params) -> SearchParams:
    return params if isinstance(params, SearchParams) else SearchParams(
        **params)


def _opts(opts) -> SearchOpts:
    if isinstance(opts, SearchOpts):
        return opts
    opts = dict(opts)
    if opts.get("w_ladder") is not None:
        opts["w_ladder"] = tuple(int(w) for w in opts["w_ladder"])
    return SearchOpts(**opts)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype).to(device)


def index_from_arrays(points, dense, counts, sat, overflow, anchor_points,
                      origin, *, spec, params, opts,
                      device="cuda") -> NeighborIndex:
    """A :class:`NeighborIndex` from the arrays of a built index."""
    dev = resolve_device(device)
    spec, params, opts = _spec(spec), _params(params), _opts(opts)
    dx, dy, dz = spec.dims
    grid = CellGrid(
        spec=spec,
        dense=_tensor(dense, torch.int32, dev).reshape(dx, dy, dz,
                                                       spec.capacity),
        counts=_tensor(counts, torch.int32, dev).reshape(dx, dy, dz),
        sat=_tensor(sat, torch.int32, dev).reshape(dx + 1, dy + 1, dz + 1),
        overflow=_tensor(overflow, torch.int32, dev).reshape(()))
    return NeighborIndex(
        params=params, opts=opts,
        statics=megacell_statics(spec.cell_size, params, opts.w_max),
        points=_tensor(points, torch.float32, dev), grid=grid,
        anchor_points=_tensor(anchor_points, torch.float32, dev),
        origin=None if origin is None else _tensor(origin, torch.float32,
                                                   dev))


def plan_from_arrays(perm, tile_levels, *, nq: int, tile: int, ladder,
                     device="cuda") -> QueryPlan:
    """A :class:`QueryPlan` from a captured permutation and tile levels."""
    dev = resolve_device(device)
    return QueryPlan(
        nq=int(nq), tile=int(tile),
        ladder=tuple((int(w), bool(s)) for w, s in ladder),
        perm=_tensor(perm, torch.int32, dev),
        tile_levels=_tensor(tile_levels, torch.int32, dev))
