"""Fused gather -> distance -> streaming top-K over anchored tile windows.

:func:`knn_tile_anchored` is the port of the reference's Pallas kernel of
the same name (``src/repro/kernels/knn_tile.py``). On a CUDA tensor it
launches the hand-written kernel ``csrc/knn_tile_anchored.cu`` (built by
``kernels/build.py``); on a CPU tensor it runs
:func:`knn_tile_anchored_plain`, the same arithmetic in plain PyTorch.
There is no fallback from one to the other.

Unlike the reference, which launches once per ladder level with the other
levels' tiles masked off (a TPU construct), ONE launch covers every tile:
each tile reads its ``(wx, wy, wz, skip)`` from ``table[levels[tile]]``. A
tile whose level lies outside the table emits neutral rows (inf, -1), like
an off-level tile of the reference.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .ref import dot3, topk_select

Tensor = torch.Tensor

MAX_K = 128            # largest k the CUDA kernel takes
MAX_TILE = 1024        # threads per CTA
_BIG = 3.4e38          # the reference's "empty" distance sentinel
_PLAIN_CHUNK = 65536   # candidates per merge step of the plain version


def _check(q, points, dense_flat, anchors, levels, table, dims, cap, k,
           tile):
    n_tiles = anchors.shape[0]
    expect = (
        (q, torch.float32, (n_tiles * tile, 3)),
        (points, torch.float32, (points.shape[0], 3)),
        (dense_flat, torch.int32, (dims[0] * dims[1] * dims[2] * cap,)),
        (anchors, torch.int32, (n_tiles, 3)),
        (levels, torch.int32, (n_tiles,)),
        (table, torch.int32, (table.shape[0], 4)),
    )
    for i, (t, dtype, shape) in enumerate(expect):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"knn_tile_anchored: argument {i} is {t.dtype} "
                f"{tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != q.device:
            raise ValueError("knn_tile_anchored: tensors on different "
                             f"devices ({t.device} vs {q.device})")
    if points.shape[0] < 1:
        raise ValueError("knn_tile_anchored: empty points table")
    if k < 1:
        raise ValueError(f"knn_tile_anchored: k={k} must be >= 1")


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    lib = load("knn_tile_anchored")
    fn = lib.knn_tile_anchored_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                   ctypes.c_float, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def knn_tile_anchored(
    q: Tensor,            # [n_tiles * tile, 3] f32, scheduled queries
    points: Tensor,       # [N, 3] f32 coordinate table
    dense_flat: Tensor,   # [Dx*Dy*Dz*cap] i32 flattened cell grid
    anchors: Tensor,      # [n_tiles, 3] i32 window anchors (pre-clipped)
    levels: Tensor,       # [n_tiles] i32 row of ``table`` per tile
    table: Tensor,        # [n_entries, 4] i32 (wx, wy, wz, skip) per level
    *,
    dims: tuple,
    cap: int,
    k: int,
    r2: float,
    tile: int,
) -> tuple[Tensor, Tensor]:
    """Streaming top-K of every query against its tile's anchored window of
    ``wx*wy*wz*cap`` candidate slots, in window order.

    Returns (d2 [Nq, k] f32 ascending, inf-padded; idx [Nq, k] i32,
    -1-padded). Candidates beyond ``r2`` are dropped unless the level's
    skip flag is set; ties keep the earlier window position.
    """
    _check(q, points, dense_flat, anchors, levels, table, dims, cap, k, tile)
    if q.device.type == "cpu":
        return knn_tile_anchored_plain(q, points, dense_flat, anchors,
                                       levels, table, dims=dims, cap=cap,
                                       k=k, r2=r2, tile=tile)
    if q.device.type != "cuda":
        raise ValueError(f"knn_tile_anchored: no kernel for {q.device}")
    if tile % 32 or not 32 <= tile <= MAX_TILE:
        raise ValueError(f"knn_tile_anchored: tile={tile} must be a "
                         f"multiple of 32 in [32, {MAX_TILE}]")
    if k > MAX_K:
        raise ValueError(f"knn_tile_anchored: k={k} exceeds {MAX_K}")
    if dense_flat.numel() >= 2 ** 31 or points.shape[0] >= 2 ** 31:
        raise ValueError("knn_tile_anchored: grid or points exceed int32")
    for t in (q, points, dense_flat, anchors, levels, table):
        if not t.is_contiguous():
            raise ValueError("knn_tile_anchored: tensors must be contiguous")
    n_tiles = anchors.shape[0]
    out_d2 = torch.empty((n_tiles * tile, k), dtype=torch.float32,
                         device=q.device)
    out_idx = torch.empty((n_tiles * tile, k), dtype=torch.int32,
                          device=q.device)
    if n_tiles == 0:
        return out_d2, out_idx
    launch = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), points.data_ptr(), dense_flat.data_ptr(),
                     anchors.data_ptr(), levels.data_ptr(), table.data_ptr(),
                     table.shape[0], n_tiles, tile, points.shape[0],
                     dense_flat.numel(), dims[1], dims[2], cap, k,
                     float(np.float32(r2)), out_d2.data_ptr(),
                     out_idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_tile_anchored: kernel launch failed "
                           f"(cudaError {err})")
    knn_tile_anchored.launches += 1
    return out_d2, out_idx


knn_tile_anchored.launches = 0


def knn_tile_anchored_plain(q, points, dense_flat, anchors, levels, table,
                            *, dims, cap, k, r2, tile):
    """Plain PyTorch version of :func:`knn_tile_anchored`: the same
    elementwise arithmetic, selected by a stable sort.

    Loops over tiles, and over each window in chunks of ``_PLAIN_CHUNK``
    candidates merged into the running best (held entries first, so the
    order equals one stable sort over the whole window). It reads the
    levels, anchors and table on the host, so it synchronises on CUDA.
    """
    dev = q.device
    n_tiles = anchors.shape[0]
    _, dy, dz = dims
    n_flat = dense_flat.shape[0]
    n_pts = points.shape[0]
    out_d2 = torch.full((n_tiles * tile, k), float("inf"),
                        dtype=torch.float32, device=dev)
    out_idx = torch.full((n_tiles * tile, k), -1, dtype=torch.int32,
                         device=dev)
    r2_t = torch.tensor(np.float32(r2)).to(dev)
    big = torch.tensor(np.float32(_BIG)).to(dev)
    table_h, levels_h, anchors_h = (table.tolist(), levels.tolist(),
                                    anchors.tolist())
    for i in range(n_tiles):
        lvl = levels_h[i]
        if not 0 <= lvl < len(table_h):
            continue
        wx, wy, wz, skip = table_h[lvl]
        ax, ay, az = anchors_h[i]
        m = wx * wy * wz * cap
        qt = q[i * tile:(i + 1) * tile]
        qn = dot3(qt, qt)[:, None]
        best_d2 = torch.full((tile, 0), float("inf"), device=dev)
        best_idx = torch.full((tile, 0), -1, dtype=torch.int32, device=dev)
        for base in range(0, m, _PLAIN_CHUNK):
            c = torch.arange(base, min(m, base + _PLAIN_CHUNK), device=dev)
            slot, cell = c % cap, c // cap
            iz, iy, ix = cell % wz, (cell // wz) % wy, cell // (wz * wy)
            flat = (((ax + ix) * dy + (ay + iy)) * dz + (az + iz)) * cap + slot
            ids = dense_flat[flat.clamp(0, n_flat - 1)]
            p = points[ids.clamp(0, n_pts - 1).long()]
            pn = dot3(p, p)[None, :]
            cross = dot3(qt[:, None, :], p[None, :, :])
            d2 = torch.clamp_min(qn + pn - 2.0 * cross, 0.0)
            # the kernel's list starts at _BIG: nothing >= _BIG enters it
            invalid = (ids < 0)[None, :] | (d2 >= big)
            if not skip:
                invalid = invalid | (d2 > r2_t)
            d2 = torch.where(invalid, float("inf"), d2)
            idx = torch.where(invalid, -1, ids[None, :])
            best_d2, best_idx = topk_select(torch.cat([best_d2, d2], 1),
                                            torch.cat([best_idx, idx], 1), k)
        if best_d2.shape[1]:
            out_d2[i * tile:(i + 1) * tile] = best_d2
            out_idx[i * tile:(i + 1) * tile] = best_idx
    return out_d2, out_idx
