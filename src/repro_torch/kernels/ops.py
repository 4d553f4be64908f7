"""The kernel layer's entry point and the fused search path
(``SearchOpts(use_pallas=True)``).

It exports every kernel of the port (``knn_tile_anchored``, ``knn_tile``,
``range_count``, ``distance_tile``, ``bin_disp_tile``) beside the fused
search path built on the first.

Each Morton-contiguous query tile gathers ONE shared cell window, the
union of its members' windows. Window sizes come from a host-static ladder
(:func:`segment_levels`): the launch-signature windows extended with
geometric escalations capped at the grid dims, so assignment is total.
Each tile is assigned on the device the smallest entry that covers its
members' union window, and ONE launch of
:func:`~.knn_tile.knn_tile_anchored` runs every tile, reading its sphere
test from a small device table by its level and its window extent from a
per-tile array. (The reference makes one masked launch per level, which is
a TPU construct; on the card a launch per level would cost a host sync
each to skip the empty ones.)

A full-radius tile (its signature's window at least ``w_full`` cells, the
sphere test on) walks the exact box of its members' windows instead of its
ladder cube (:func:`launch_inputs`): every member's r-ball lies inside the
box, and the kernel orders candidates by (d2, grid cell, slot) whatever the
window's anchor and extent, so its rows are bitwise those of the cube,
which always holds the box. Below full radius a window decides what is
returned (a ``skip`` level's bounded subset, a knn megacell window), so
those tiles keep the reference's ladder entry.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..core.partition import full_window_radius
from ..core.types import device_table
from .distance_tile import distance_tile
from .knn_tile import knn_tile, knn_tile_anchored
from .range_tile import range_count
from .update_tile import bin_disp_tile

Tensor = torch.Tensor

@lru_cache(maxsize=512)
def segment_levels(
    ladder: tuple,              # ((w, skip), ...) launch signatures
    dims: tuple,                # grid dims (static)
) -> tuple:
    """Host-static launch ladder: ``((ws3, skip), ...)`` entries in
    ascending window volume.

    Base sizes are the signatures' ``2w+1``; because a Morton tile spans
    more than one cell, the set is extended with geometrically growing
    escalations capped at the grid dims. The final whole-grid entry always
    fits, which makes the first-fit assignment total. Every size is crossed
    with the skip flags present in the signature ladder.
    """
    sizes = sorted({2 * int(w) + 1 for w, _ in ladder})
    dmax = max(dims)
    s = sizes[-1]
    while s < dmax:
        # jump straight to the whole grid once doubling would land within
        # a cell of it
        s = dmax if 2 * s + 1 >= dmax - 1 else 2 * s + 1
        sizes.append(s)
    skips = sorted({bool(sk) for _, sk in ladder})
    entries, seen = [], set()
    for s in sizes:
        ws = tuple(min(s, d) for d in dims)
        for sk in skips:
            if (ws, sk) not in seen:
                seen.add((ws, sk))
                entries.append((ws, sk))
    return tuple(entries)


@lru_cache(maxsize=512)
def _ladder_tables(ladder: tuple, entries: tuple, dims: tuple,
                   device: torch.device):
    """Device copies of the host-static tables, cached per device so that
    planning issues no host-to-device copy after the first call."""
    w_arr = device_table([int(w) for w, _ in ladder], torch.int32, device)
    s_arr = device_table([bool(s) for _, s in ladder], torch.bool, device)
    ws_table = device_table([ws for ws, _ in entries], torch.int32, device)
    sk_arr = device_table([bool(sk) for _, sk in entries], torch.bool,
                          device)
    table = device_table([(*ws, int(sk)) for ws, sk in entries],
                         torch.int32, device)
    dims_a = device_table(dims, torch.int32, device)
    return w_arr, s_arr, ws_table, sk_arr, table, dims_a


def assign_tile_levels(
    qcells: Tensor,             # [n_tiles, tile, 3] i32 member cell coords
    tile_levels: Tensor,        # [n_tiles] i32 index into ``ladder``
    ladder: tuple,
    entries: tuple,             # segment_levels(ladder, dims)
    dims: tuple,
) -> tuple[Tensor, Tensor]:
    """Per-tile (launch level, window anchor), computed on the device.

    Per tile, the min/max cell coords of its members plus the signature
    window radius give the union window; the tile takes the first entry
    (matching skip flag) that covers it, and its anchor is clamped so the
    whole window lies inside the grid. Returns
    ``(plevel [n_tiles] i32, anchors [n_tiles, 3] i32)``.
    """
    w_arr, s_arr, ws_table, sk_arr, _, dims_a = _ladder_tables(
        tuple(ladder), tuple(entries), tuple(dims), qcells.device)
    lo = qcells.min(dim=1).values                          # [n_tiles, 3]
    hi = qcells.max(dim=1).values
    lvl = tile_levels.clamp(0, len(ladder) - 1).long()
    tile_w = w_arr[lvl][:, None]                           # [n_tiles, 1]
    tile_skip = s_arr[lvl]
    need = torch.minimum(hi - lo + 1 + 2 * tile_w, dims_a)  # per-axis cells

    # first fit in ascending volume; the defensive fallback never lands a
    # no-skip tile on a skip entry
    no_skip = [i for i, (_, sk) in enumerate(entries) if not sk]
    fb = no_skip[-1] if no_skip else len(entries) - 1
    fits = (torch.all(need[:, None, :] <= ws_table[None], dim=-1)
            & (tile_skip[:, None] == sk_arr[None]))        # [n_tiles, E]
    first = torch.argmax(fits.to(torch.int32), dim=1).to(torch.int32)
    plevel = torch.where(fits.any(dim=1), first, fb)
    ws_tile = ws_table[plevel.long()]                       # [n_tiles, 3]
    anchors = torch.minimum((lo - tile_w).clamp_min(0), dims_a - ws_tile)
    return plevel.to(torch.int32), anchors.to(torch.int32)


def window_search_segmented(
    grid,                 # core.types.CellGrid
    points: Tensor,
    queries: Tensor,      # [Nq, 3], Nq % tile == 0 (caller pads)
    spec,                 # core.types.GridSpec
    ladder: tuple,        # ((w, skip), ...) launch signatures
    tile_levels: Tensor,  # [Nq // tile] i32 per-tile signature level
    radius: float,
    k: int,
    tile: int,
    origin: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused search of the (level, Morton)-ordered query tiles in one
    kernel launch. Returns ``(d2 [Nq, k], idx [Nq, k], cnt [Nq])`` in the
    scheduled query order; no host synchronisation."""
    args, kw = launch_inputs(grid, points, queries, spec, ladder,
                             tile_levels, radius, k, tile, origin)
    d2, idx = knn_tile_anchored(*args, **kw)
    cnt = torch.sum(idx >= 0, dim=1).to(torch.int32)
    return d2, idx, cnt


@lru_cache(maxsize=512)
def _full_radius_levels(ladder: tuple, w_full: int,
                        device: torch.device) -> tuple[bool, Tensor]:
    """Whether any signature of ``ladder`` is at full radius (a window of
    at least ``w_full`` cells, the sphere test on), and which, as a device
    table."""
    full = [int(w) >= w_full and not sk for w, sk in ladder]
    return any(full), device_table(full, torch.bool, device)


def launch_inputs(grid, points, queries, spec, ladder, tile_levels, radius,
                  k, tile, origin=None):
    """The positional and keyword arguments of the one
    :func:`~.knn_tile.knn_tile_anchored` launch over ``queries``:
    ``[queries, points, dense_flat, anchors, plevel, table, extents]`` and
    ``dims``/``cap``/``k``/``r2``/``tile``.

    Every tile takes :func:`assign_tile_levels`' entry (``plevel``). A tile
    whose signature is at full radius walks the box ``[lo - w_full, hi +
    w_full]`` of its members' cells, clipped to the grid (its anchor and
    extent); every other tile walks its entry's cube from that function's
    anchor. Computed on the device, with no host synchronisation."""
    nq = queries.shape[0]
    n_tiles = nq // tile
    if n_tiles * tile != nq:
        raise ValueError(f"{nq} queries are not a multiple of tile {tile}")
    ladder, dims = tuple(ladder), tuple(spec.dims)
    entries = segment_levels(ladder, dims)
    qc = spec.cell_of(queries, origin).reshape(n_tiles, tile, 3)
    plevel, anchors = assign_tile_levels(qc, tile_levels, ladder, entries,
                                         dims)
    _, _, ws_table, _, table, dims_a = _ladder_tables(ladder, entries, dims,
                                                      queries.device)
    extents = ws_table[plevel.long()]
    w_full = full_window_radius(spec.cell_size, radius)
    any_full, full = _full_radius_levels(ladder, w_full, queries.device)
    if any_full:
        boxed = full[tile_levels.clamp(0, len(ladder) - 1).long()][:, None]
        lo = (qc.min(dim=1).values - w_full).clamp_min(0)
        hi = torch.minimum(qc.max(dim=1).values + w_full, dims_a - 1)
        anchors = torch.where(boxed, lo, anchors)
        extents = torch.where(boxed, hi - lo + 1, extents)
    args = [queries.contiguous(), points, grid.dense.reshape(-1), anchors,
            plevel, table, extents]
    kw = dict(dims=dims, cap=spec.capacity, k=k, r2=float(radius) ** 2,
              tile=tile)
    return args, kw


def window_search_pallas(
    grid,                 # core.types.CellGrid
    points: Tensor,
    queries: Tensor,      # [Nq, 3]
    spec,                 # core.types.GridSpec
    w: int,
    radius: float,
    k: int,
    skip_test: bool,
    tile: int = 256,
    origin: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused-path counterpart of ``core.search.window_search`` (a single
    launch signature). Returns ``(idx, d2, cnt)``."""
    from ..core.search import _pad_edge
    nq = queries.shape[0]
    # edge-replicate to the tile multiple: padded rows repeat the last real
    # query, so they cannot distort the shared tile-window anchors
    qp = _pad_edge(queries, nq + (-nq) % tile)
    n_tiles = qp.shape[0] // tile
    ladder = ((int(w), bool(skip_test)),)
    tile_levels = torch.zeros((n_tiles,), dtype=torch.int32,
                              device=queries.device)
    d2, idx, cnt = window_search_segmented(
        grid, points, qp, spec, ladder, tile_levels, radius, k, tile,
        origin=origin)
    return idx[:nq], d2[:nq], cnt[:nq]


# The reference also exports ``INTERPRET``, its switch for Pallas interpret
# mode. A CUDA kernel has no interpret mode (on CPU tensors every wrapper
# runs its plain version), so the port has no such switch.
__all__ = ["bin_disp_tile", "distance_tile", "knn_tile",
           "knn_tile_anchored", "range_count", "segment_levels",
           "assign_tile_levels", "launch_inputs", "window_search_segmented",
           "window_search_pallas"]
