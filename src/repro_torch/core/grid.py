"""Uniform cell grid build: bin + stable-rank scatter + summed-area table.

The build path of the reference's ``core/grid.py``. The reference's
scatters use ``mode="drop"`` to discard out-of-range slots; PyTorch's index
ops raise on the CPU and assert on CUDA instead, so the port routes dropped
slots to one extra dump slot past the end and slices it off. That keeps the
build free of host synchronisation (a boolean mask or ``bincount`` would
sync on CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from .types import (PARK_THRESHOLD, CellGrid, GridSpec, Tensor,
                    device_table)


def parked_mask(points: Tensor) -> Tensor:
    """Rows parked at the slab-padding sentinel: any coordinate with
    magnitude >= ``PARK_THRESHOLD``."""
    return torch.any(points.abs() >= PARK_THRESHOLD, dim=-1)


def choose_grid_spec(
    points: np.ndarray,
    radius: float,
    *,
    cell_size: float | None = None,
    max_dim: int = 256,
    capacity: int | None = None,
    capacity_slack: float = 1.0,
    domain_margin: float = 0.0,
) -> GridSpec:
    """Host-side (numpy) planning of the static grid parameters.

    Default cell edge is a quarter of the search radius, coarsened while
    the dense array would exceed ``max_dim`` cells per axis; the domain is
    padded by one cell per side (plus ``domain_margin`` world units), and
    ``capacity`` is read from the data as the maximum cell occupancy.
    """
    points = np.asarray(points, dtype=np.float32)
    lo = points.min(axis=0) - domain_margin
    hi = points.max(axis=0) + domain_margin
    extent = np.maximum(hi - lo, max(float(radius), 1e-6))
    if cell_size is None:
        cell_size = float(max(radius / 4.0, extent.max() / max_dim))
    origin = lo - cell_size
    dims = tuple(int(d) for d in np.ceil(extent / cell_size).astype(int) + 3)
    dims = tuple(min(int(d), max_dim + 3) for d in dims)
    if capacity is None:
        cc = np.floor((points - origin) / cell_size).astype(np.int64)
        cc = np.clip(cc, 0, np.asarray(dims) - 1)
        flat = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
        occ = np.bincount(flat, minlength=dims[0] * dims[1] * dims[2])
        capacity = int(max(1, np.ceil(occ.max() * capacity_slack)))
    return GridSpec(
        origin=tuple(float(o) for o in origin),
        cell_size=float(cell_size),
        dims=dims,
        capacity=int(capacity),
    )


def build_cell_grid(points: Tensor, spec: GridSpec,
                    origin: Tensor | None = None,
                    valid: Tensor | None = None) -> CellGrid:
    """Bin ``points`` [N, 3] into the dense fixed-capacity cell list.

    A point's slot is its rank among same-cell points in input order;
    points beyond ``capacity`` are dropped and counted in ``overflow``.
    ``origin`` overrides the spec origin; rows with ``valid`` False are
    left out of the grid entirely.
    """
    flat = spec.flat_cell(spec.cell_of(points, origin))
    if valid is not None:
        flat = torch.where(valid, flat, spec.num_cells)
    return _grid_from_flat(flat, points.shape[0], spec)


def _grid_from_flat(flat: Tensor, n: int, spec: GridSpec) -> CellGrid:
    """Dense grid + counts + SAT from flat cell ids [N] int32 (an id equal
    to ``num_cells`` marks a row that belongs to no cell)."""
    dev = flat.device
    cap, n_cells = spec.capacity, spec.num_cells
    order = torch.argsort(flat, stable=True)
    flat_sorted = flat[order]
    # rank within cell = position - first position of this cell id
    first_of_cell = torch.searchsorted(flat_sorted, flat_sorted, side="left")
    rank_sorted = (torch.arange(n, dtype=torch.int32, device=dev)
                   - first_of_cell.to(torch.int32))
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[order] = rank_sorted

    # dropped rows (over capacity, or no cell) all write to the dump slot
    # past the end; several rows may land there, and it is sliced off
    dump = n_cells * cap
    keep = (rank < cap) & (flat < n_cells)
    slot = torch.where(keep, flat.to(torch.int64) * cap + rank, dump)
    dense = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    dense[slot] = torch.arange(n, dtype=torch.int32, device=dev)
    dense = dense[:dump]

    counts_full = torch.zeros((n_cells + 1,), dtype=torch.int32, device=dev)
    counts_full.index_add_(0, flat.to(torch.int64),
                           torch.ones((n,), dtype=torch.int32, device=dev))
    counts_full = counts_full[:n_cells]
    clipped = torch.clamp_max(counts_full, cap)
    overflow = torch.sum(counts_full - clipped).to(torch.int32)
    dx, dy, dz = spec.dims
    counts = clipped.reshape(dx, dy, dz)
    return CellGrid(spec=spec, dense=dense.reshape(dx, dy, dz, cap),
                    counts=counts, sat=_summed_area_table(counts),
                    overflow=overflow)


def _summed_area_table(counts: Tensor) -> Tensor:
    """3-D inclusive summed-area table with a zero border at index 0."""
    s = counts.cumsum(0, dtype=torch.int32).cumsum(
        1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
    dx, dy, dz = counts.shape
    sat = torch.zeros((dx + 1, dy + 1, dz + 1), dtype=torch.int32,
                      device=counts.device)
    sat[1:, 1:, 1:] = s
    return sat


def box_count(sat: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Number of points with cell coords in the inclusive box [lo, hi]
    (int32 [..., 3] each, already clamped to the grid): 8-corner
    inclusion-exclusion on the SAT."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64) + 1
    x0, y0, z0 = lo[..., 0], lo[..., 1], lo[..., 2]
    x1, y1, z1 = hi[..., 0], hi[..., 1], hi[..., 2]

    def g(a, b, c):
        return sat[a, b, c]

    return (
        g(x1, y1, z1)
        - g(x0, y1, z1) - g(x1, y0, z1) - g(x1, y1, z0)
        + g(x0, y0, z1) + g(x0, y1, z0) + g(x1, y0, z0)
        - g(x0, y0, z0)
    )


def clamp_box(spec: GridSpec, center: Tensor, w) -> tuple[Tensor, Tensor]:
    """Inclusive cell box of half-width ``w`` around ``center``, clamped."""
    hi_lim = device_table([d - 1 for d in spec.dims], torch.int32,
                          center.device)
    lo = torch.minimum((center - w).clamp_min(0), hi_lim)
    hi = torch.minimum((center + w).clamp_min(0), hi_lim)
    return lo, hi
