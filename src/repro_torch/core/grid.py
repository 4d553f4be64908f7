"""Uniform cell grid: bin + stable-rank scatter + summed-area table, and
the incremental update of a frozen grid for dynamic scenes.

The reference's ``core/grid.py`` on tensors. Its scatters use
``mode="drop"`` to discard out-of-range slots; PyTorch's index ops raise
on the CPU and assert on CUDA instead. So the port adds ``id + 1`` into a
grid filled with -1 and adds 0 for a dropped row, and routes dropped
counts to one extra slot past the end that is sliced off. That keeps the
build and the update free of host synchronisation (a boolean mask or
``bincount`` would sync on CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import sq_dist
from .types import (PARK_THRESHOLD, CellGrid, GridSpec, Tensor, UpdateStats,
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


def _grid_from_flat(flat: Tensor, n: int, spec: GridSpec,
                    out: Tensor | None = None) -> CellGrid:
    """Dense grid + counts + SAT from flat cell ids [N] int32 (an id equal
    to ``num_cells`` marks a row that belongs to no cell). With ``out``, a
    dense grid of this spec, the new dense grid is written into its
    storage instead of a new allocation."""
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

    # every kept row owns its slot, so adding id + 1 into the -1 fill
    # stores id; dropped rows (over capacity, or no cell) add 0 to slot 0
    keep = (rank < cap) & (flat < n_cells)
    slot = torch.where(keep, flat.to(torch.int64) * cap + rank, 0)
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    dense = (torch.empty((n_cells * cap,), dtype=torch.int32, device=dev)
             if out is None else out.view(-1))
    dense.fill_(-1)
    dense.index_add_(0, slot, torch.where(keep, ids, 0))

    counts_full = torch.zeros((n_cells + 1,), dtype=torch.int32, device=dev)
    counts_full.index_add_(0, flat.to(torch.int64),
                           torch.ones((n,), dtype=torch.int32, device=dev))
    counts_full = counts_full[:n_cells]
    clipped = torch.clamp_max(counts_full, cap)
    overflow = torch.sum(counts_full - clipped).to(torch.int32)
    dx, dy, dz = spec.dims
    counts = clipped.reshape(dx, dy, dz)
    return CellGrid(spec=spec, dense=dense.view(dx, dy, dz, cap),
                    counts=counts, sat=_summed_area_table(counts),
                    overflow=overflow)


# ---------------------------------------------------------------------------
# dynamic-scene incremental update (core/dynamic.py)
# ---------------------------------------------------------------------------

def _bin_and_stats(spec: GridSpec, points: Tensor, anchor_points: Tensor,
                   origin: Tensor | None = None,
                   valid: Tensor | None = None
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Binning + motion statistics, plain path (``use_pallas=False``).

    Returns ``(ccoord [N, 3] clipped, oob, max_disp2)``: ``oob`` counts the
    points whose true cell lies outside the frozen grid, ``max_disp2`` is
    the largest squared displacement against ``anchor_points``. The cell
    divides by the float32 cell size, as :meth:`GridSpec.cell_of` does;
    ``valid`` [N] leaves rows out of both statistics.
    """
    dev = points.device
    o = (device_table(spec.origin, torch.float32, dev) if origin is None
         else origin.to(torch.float32))
    cs = device_table(np.float32(spec.cell_size), torch.float32, dev)
    hi = device_table([d - 1 for d in spec.dims], torch.float32, dev)
    c = torch.floor((points - o) / cs)
    escaped = torch.any((c < 0) | (c > hi), dim=-1)
    d2 = sq_dist(points, anchor_points)
    if valid is not None:
        escaped = escaped & valid
        d2 = torch.where(valid, d2, 0.0)
    oob = torch.sum(escaped, dtype=torch.int32)
    max_d2 = (torch.max(d2) if d2.numel()
              else torch.zeros((), dtype=torch.float32, device=dev))
    return torch.minimum(c.clamp_min(0.0), hi).to(torch.int32), oob, max_d2


def _update_impl(grid: CellGrid, points: Tensor, anchor_points: Tensor,
                 use_pallas: bool, origin: Tensor | None = None,
                 mask_parked: bool = False, donate: bool = False):
    spec = grid.spec
    valid = torch.logical_not(parked_mask(points)) if mask_parked else None
    if use_pallas:
        from ..kernels.update_tile import bin_disp_tile
        ccoord, oob, max_d2 = bin_disp_tile(points, anchor_points, spec,
                                            origin=origin,
                                            mask_parked=mask_parked)
    else:
        ccoord, oob, max_d2 = _bin_and_stats(spec, points, anchor_points,
                                             origin, valid)
    flat = spec.flat_cell(ccoord)
    if valid is not None:
        flat = torch.where(valid, flat, spec.num_cells)
    new = _grid_from_flat(flat, points.shape[0], spec,
                          out=grid.dense if donate else None)
    stats = UpdateStats(overflow=new.overflow, oob=oob, max_disp2=max_d2)
    return new, stats, ccoord


def update_cell_grid(
    grid: CellGrid,
    points: Tensor,
    anchor_points: Tensor,
    *,
    use_pallas: bool = False,
    donate: bool | None = None,
    origin: Tensor | None = None,
    mask_parked: bool = False,
) -> tuple[CellGrid, UpdateStats, Tensor]:
    """Re-bin moved ``points`` into the *frozen* spec of ``grid``.

    Binning, the overflow and out-of-bounds counters and the
    max-displacement statistic come out of one pass with no host
    synchronisation; ``use_pallas`` bins with the hand-written kernel
    ``kernels/update_tile.bin_disp_tile``. ``donate=True`` writes the new
    dense grid into the storage of ``grid.dense``, so that two dense grids
    are not live at once; ``grid`` must not be used afterwards. ``None``
    donates off the CPU, as the reference's auto setting does.

    Returns ``(grid', stats, ccoord)``; ``ccoord`` is the per-point cell.
    """
    if donate is None:
        donate = grid.dense.device.type != "cpu"
    return _update_impl(grid, points, anchor_points, use_pallas, origin,
                        mask_parked, donate=bool(donate))


def update_cell_grid_traced(
    grid: CellGrid,
    points: Tensor,
    anchor_points: Tensor,
    *,
    use_pallas: bool = False,
    origin: Tensor | None = None,
    mask_parked: bool = False,
) -> tuple[CellGrid, UpdateStats, Tensor]:
    """:func:`update_cell_grid` with ``donate=False``, under the
    reference's name for its traced core (which jitted programs inline;
    PyTorch runs eagerly, so here it is the same update). ``update_index``
    calls :func:`update_cell_grid` with its own ``donate``."""
    return _update_impl(grid, points, anchor_points, use_pallas, origin,
                        mask_parked)


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
