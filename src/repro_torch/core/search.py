"""Per-tile window search: the plain tensor path (``use_pallas=False``).

Each query tile gathers, for each query, the (2w+1)^3 cell window around
its own cell from the dense grid, computes squared distances, filters by
the radius (unless the sphere test is skipped) and selects the k nearest.

``REPRO_SELECTION`` picks the selection as in the reference: ``topk``
(partial selection, the default) or ``sort`` (stable full sort). Both keep
the reference's tie order, lower window position first. ``torch.topk``
promises no tie order, so the ``topk`` mode selects on an explicit
(d2, position) key.

The host-planned ``NeighborSearch``/``neighbor_search`` surfaces belong to
the executor and are not ported yet.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..kernels.ref import dot3, topk_select
from .types import CellGrid, GridSpec, Tensor, device_table

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
