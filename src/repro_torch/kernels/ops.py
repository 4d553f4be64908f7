"""The fused search path (``SearchOpts(use_pallas=True)``).

Each Morton-contiguous query tile gathers ONE shared cell window, the
union of its members' windows. Window sizes come from a host-static ladder
(:func:`segment_levels`): the launch-signature windows extended with
geometric escalations capped at the grid dims, so assignment is total.
Each tile is assigned on the device the smallest entry that covers its
members' union window, and ONE launch of
:func:`~.knn_tile.knn_tile_anchored` runs every tile, reading its window
size from a small device table by its level. (The reference makes one
masked launch per level, which is a TPU construct; on the card a launch
per level would cost a host sync each to skip the empty ones.)
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..core.types import device_table
from .knn_tile import knn_tile_anchored

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


def launch_inputs(grid, points, queries, spec, ladder, tile_levels, radius,
                  k, tile, origin=None):
    """The positional and keyword arguments of the one
    :func:`~.knn_tile.knn_tile_anchored` launch over ``queries``:
    ``[queries, points, dense_flat, anchors, plevel, table]`` and
    ``dims``/``cap``/``k``/``r2``/``tile``."""
    nq = queries.shape[0]
    n_tiles = nq // tile
    if n_tiles * tile != nq:
        raise ValueError(f"{nq} queries are not a multiple of tile {tile}")
    dims = tuple(spec.dims)
    entries = segment_levels(tuple(ladder), dims)
    qc = spec.cell_of(queries, origin).reshape(n_tiles, tile, 3)
    plevel, anchors = assign_tile_levels(qc, tile_levels, tuple(ladder),
                                         entries, dims)
    table = _ladder_tables(tuple(ladder), entries, dims, queries.device)[4]
    args = [queries.contiguous(), points, grid.dense.reshape(-1), anchors,
            plevel, table]
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


__all__ = ["knn_tile_anchored", "segment_levels", "assign_tile_levels",
           "launch_inputs", "window_search_segmented", "window_search_pallas"]
