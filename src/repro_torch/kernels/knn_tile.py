"""Fused gather -> distance -> streaming top-K over tile windows.

Two kernels share the distance arithmetic and the strictly-less insertion
rule (``csrc/knn_stream.cuh``), as the reference's two Pallas kernels of
the same names (``src/repro/kernels/knn_tile.py``) share their stream:

* :func:`knn_tile_anchored` derives each tile's candidate ids from its
  window anchor inside the kernel (the main path). Its kernel reads the
  slots of occupied cells only and compacts the valid ones, splits a large
  window into work items of at most :data:`SEG` slots across CTAs
  (:func:`work_items`), and merges their partial top-Ks by (d2, window
  position), in any order;
* :func:`knn_tile` streams a caller-supplied candidate-id stream
  ``[n_tiles, M]`` (-1 = invalid), the kernel layer's public entry point.
  Its kernel cuts each stream into work items of consecutive positions
  across a grid that fills the card (:func:`stream_split`, shared with
  ``range_count``), compacts the valid ids, and merges the items' partial
  top-Ks by (d2, stream position), in any order. Its CTAs hold at most
  256 query rows.

On a CUDA tensor each launches its hand-written kernel (``csrc/<name>.cu``,
built by ``kernels/build.py``); on a CPU tensor it runs its plain version,
the same arithmetic in plain PyTorch. There is no fallback from one to the
other. On the ids of an anchored window, in window order, the two kernels
agree bitwise, and so do the two plain versions.

Both take any k >= 1 and any query tile that is a positive multiple of 8,
as the reference does. A launch keeps a list of at most :data:`MAX_K`
entries; a larger k runs as ``ceil(k / MAX_K)`` passes, pass p keeping the
candidates whose key (d2, window position) lies after the last key of pass
p - 1 (carried per query in scratch) and writing output columns
``[MAX_K * p, MAX_K * p + MAX_K)``. A CTA holds at most :data:`MAX_ROWS`
rows; a larger tile, or one that is not a whole number of warps, runs in
row blocks (:func:`row_blocks`) of a whole number of warps, masked past
the block's rows.

Unlike the reference, which launches once per ladder level with the other
levels' tiles masked off (a TPU construct), ONE launch of
``knn_tile_anchored`` covers every tile: each tile reads its
``(wx, wy, wz, skip)`` from ``table[levels[tile]]``. A tile whose level lies
outside the table emits neutral rows (inf, -1), like an off-level tile of
the reference.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..obs.lifecycle import on_reset
from .ref import dot3, topk_select

Tensor = torch.Tensor

MAX_K = 128            # longest list one launch keeps; more runs in passes
MAX_ROWS = 1024        # query rows per CTA; a larger tile runs in row blocks
_STREAM_ROWS = 256     # ... of knn_tile's kernel, two CTAs an SM: room for
                       # ptxas to keep the k <= 8 list in registers
SEG = 1 << 16          # window slots per work item of knn_tile_anchored's
                       # kernel: a larger window is split across CTAs
STREAM_SEG = 4096      # fewest ids per work item of knn_tile's and
                       # range_count's kernels (unless the stream is shorter)
_ITEMS_PER_CTA = 2     # work items per resident CTA that the split aims at
_BIG = 3.4e38          # the reference's "empty" distance sentinel
_PLAIN_CHUNK = 65536   # candidates per merge step of the plain version


def _check_args(name, q, expect):
    """Raise unless each ``(tensor, dtype, shape)`` of ``expect`` matches
    and lies on ``q``'s device."""
    for i, (t, dtype, shape) in enumerate(expect):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: argument {i} is {t.dtype} {tuple(t.shape)}, "
                f"expected {dtype} {tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {q.device})")


def _check_launch(name, tensors, tile):
    """What the CUDA launch rejects: the reference's own limit, a tile that
    is not a positive multiple of 8, and tensors that are not contiguous."""
    if tile < 8 or tile % 8:
        raise ValueError(f"{name}: tile={tile} must be a positive multiple "
                         "of 8")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def row_blocks(tile: int, max_rows: int = MAX_ROWS) -> tuple[int, int, int]:
    """How a query tile of ``tile`` rows runs on the card: ``(n_rb,
    rb_rows, block)``, its row blocks of at most ``max_rows``, the rows of
    each (the last may hold fewer) and the threads of each block's CTA, a
    whole number of warps. A tile of 32 to ``max_rows`` rows that is a
    whole number of warps is one block of itself, the unmasked kernel."""
    n_rb = -(-tile // max_rows)
    rb_rows = -(-tile // n_rb)
    return n_rb, rb_rows, -(-rb_rows // 32) * 32


def _passes(k: int) -> list[tuple[int, int]]:
    """The (first column, list length) of each launch for a top-k."""
    return [(c, min(MAX_K, k - c)) for c in range(0, k, MAX_K)]


def _check(q, points, dense_flat, anchors, levels, table, dims, cap, k,
           tile):
    n_tiles = anchors.shape[0]
    _check_args("knn_tile_anchored", q, (
        (q, torch.float32, (n_tiles * tile, 3)),
        (points, torch.float32, (points.shape[0], 3)),
        (dense_flat, torch.int32, (dims[0] * dims[1] * dims[2] * cap,)),
        (anchors, torch.int32, (n_tiles, 3)),
        (levels, torch.int32, (n_tiles,)),
        (table, torch.int32, (table.shape[0], 4)),
    ))
    if points.shape[0] < 1:
        raise ValueError("knn_tile_anchored: empty points table")
    if k < 1:
        raise ValueError(f"knn_tile_anchored: k={k} must be >= 1")


def work_items(levels: Tensor, table: Tensor, cap: int,
               seg: int = SEG) -> tuple[Tensor, Tensor]:
    """The work items of one ``knn_tile_anchored`` launch, built on the
    device with no host synchronisation.

    A tile whose level indexes ``table`` has a window of ``wx*wy*wz``
    cells, cut into items of ``seg_cells = max(1, seg // cap)`` whole
    cells (at most ``seg`` slots); a tile off the table has no cells and
    one empty item, which writes its neutral rows. Returns ``(order
    [n_tiles] i32, cum [n_tiles + 1] i32)``: the tiles by descending window
    size (stable), and ``cum[j]``, the first item of tile ``order[j]``,
    whose item ``cum[j] + s`` covers window cells ``[s*seg_cells,
    min((s+1)*seg_cells, cells))``. ``cum[-1]`` is the item count, which
    the kernel reads from device memory.
    """
    n_entries = table.shape[0]
    lvl = levels.long()
    if n_entries:
        ws = table[lvl.clamp(0, n_entries - 1), :3].long()
        on = (lvl >= 0) & (lvl < n_entries)
        cells = torch.where(on, ws.prod(dim=1), 0)
    else:
        cells = torch.zeros_like(lvl)
    seg_cells = max(1, seg // cap)
    nseg = torch.clamp_min((cells + seg_cells - 1) // seg_cells, 1)
    order = torch.argsort(cells, descending=True, stable=True)
    cum = torch.zeros(lvl.shape[0] + 1, dtype=torch.int32,
                      device=levels.device)
    cum[1:] = torch.cumsum(nseg[order], 0)
    return order.to(torch.int32), cum


def launch_scratch(levels: Tensor, table: Tensor, dense_flat: Tensor,
                   cap: int, seg: int = SEG,
                   n_rb: int = 1) -> tuple[Tensor, ...]:
    """Everything one kernel launch gets besides its inputs and outputs,
    for tiles of ``n_rb`` row blocks each (:func:`row_blocks`), a unit of
    work being one row block of one tile: :func:`work_items`' ``order`` and
    ``cum`` over the units; ``occupied`` [cells] bool, whether each grid
    cell holds any id, so that the kernel reads the slots of occupied cells
    only; and ``sync`` [2 * n_units + 1] i32 zeros (a lock and a merge
    count per unit, the item counter). In all ``16 * n_units + 8`` bytes
    plus one byte a grid cell, whatever k and the window sizes."""
    if n_rb > 1:
        levels = levels.repeat_interleave(n_rb)
    order, cum = work_items(levels, table, cap, seg)
    occupied = (dense_flat.view(-1, cap) >= 0).any(dim=1)
    sync = torch.zeros(2 * levels.shape[0] + 1, dtype=torch.int32,
                       device=levels.device)
    return order, cum, occupied, sync


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    lib = load("knn_tile_anchored")
    fn = lib.knn_tile_anchored_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, i, i,
                   i, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.knn_tile_anchored_walk_slots.restype = ctypes.c_int
    return fn, lib.knn_tile_anchored_walk_slots()


# The walk counter of knn_tile_anchored's kernel: per device, a table of
# rows (signature key, window cells looked up, occupied cells, candidate
# ids staged, candidate pairs compared) that every launch adds to on the
# device and nothing fetches but walk_counts; the launches' query rows
# are summed on the host (``knn_tile_anchored.rows``).
_WALK: dict = {}
_WALK_COUNTS = ("window_cells", "occupied_cells", "candidates",
                "candidate_pairs")


def _walk_table(device: torch.device, slots: int) -> Tensor:
    """The device's walk counter table, zeros made at its first launch (no
    host synchronisation)."""
    table = _WALK.get(device)
    if table is None:
        table = _WALK[device] = torch.zeros(
            (slots, 1 + len(_WALK_COUNTS)), dtype=torch.int64, device=device)
    return table


def walk_counts() -> dict | None:
    """What ``knn_tile_anchored``'s launches have walked since the process
    started (or the last ``reset_walk_counts``), None if none ran on a
    card: ``query_rows`` (the launches' rows, padding included), the four
    device counts summed, and ``by_signature``, the counts of each launch
    signature (window extent in cells, sphere test); a launch's levels
    past its 32nd, and a signature that found the table full, count in an
    entry with ``window`` None. Copies
    each device's table to the host once, which waits for its launches."""
    if not _WALK:
        return None
    by_sig: dict = {}
    for table in _WALK.values():
        for key, *counts in table.cpu().tolist():
            if key == 0:
                continue
            key &= (1 << 64) - 1
            sig = (None if key == (1 << 64) - 1 else
                   ((key >> 43, (key >> 22) & 0x1FFFFF, (key >> 1) & 0x1FFFFF),
                    not key & 1))
            tot = by_sig.setdefault(sig, [0] * len(_WALK_COUNTS))
            for j, n in enumerate(counts):
                tot[j] += n
    out = {"query_rows": knn_tile_anchored.rows}
    for j, name in enumerate(_WALK_COUNTS):
        out[name] = sum(c[j] for c in by_sig.values())
    out["by_signature"] = [
        dict(window=None if sig is None else list(sig[0]),
             sphere_test=None if sig is None else sig[1],
             **dict(zip(_WALK_COUNTS, counts)))
        for sig, counts in by_sig.items()]
    return out


def reset_walk_counts() -> None:
    """Zero the walk counter (on the device, no synchronisation) and the
    host's row count."""
    for table in _WALK.values():
        table.zero_()
    knn_tile_anchored.rows = 0


on_reset(reset_walk_counts)


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
    _check_launch("knn_tile_anchored",
                  (q, points, dense_flat, anchors, levels, table), tile)
    if dense_flat.numel() >= 2 ** 31 or points.shape[0] >= 2 ** 31:
        raise ValueError("knn_tile_anchored: grid or points exceed int32")
    n_tiles = anchors.shape[0]
    rows = n_tiles * tile
    out_d2 = torch.empty((rows, k), dtype=torch.float32, device=q.device)
    out_idx = torch.empty((rows, k), dtype=torch.int32, device=q.device)
    if n_tiles == 0:
        return out_d2, out_idx
    launch, walk_slots = _library()
    walk = _walk_table(q.device, walk_slots)
    seg = SEG
    n_rb, rb_rows, block = row_blocks(tile)
    order, cum, occupied, sync = launch_scratch(levels, table, dense_flat,
                                                cap, seg, n_rb)
    passes = _passes(k)
    lo_d = lo_p = None
    if len(passes) > 1:   # each query's last key of the pass before
        lo_d = torch.full((rows,), -1.0, dtype=torch.float32,
                          device=q.device)
        lo_p = torch.full((rows,), -1, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for col0, kk in passes:
            if col0:
                sync.zero_()
            err = launch(
                q.data_ptr(), points.data_ptr(), dense_flat.data_ptr(),
                anchors.data_ptr(), levels.data_ptr(), table.data_ptr(),
                table.shape[0], order.data_ptr(), cum.data_ptr(),
                occupied.data_ptr(), sync.data_ptr(), n_tiles * n_rb, tile,
                rb_rows, n_rb, block, points.shape[0], dense_flat.numel(),
                dims[1], dims[2], cap, kk, k, col0, max(1, seg // cap),
                float(np.float32(r2)),
                None if lo_d is None else lo_d.data_ptr(),
                None if lo_p is None else lo_p.data_ptr(),
                out_d2.data_ptr(), out_idx.data_ptr(), walk.data_ptr(),
                stream)
            if err != 0:
                raise RuntimeError(f"knn_tile_anchored: kernel launch "
                                   f"failed (cudaError {err})")
            knn_tile_anchored.launches += 1
            knn_tile_anchored.rows += rows
    return out_d2, out_idx


knn_tile_anchored.launches = 0
knn_tile_anchored.rows = 0


def _stream_plain(qt, points, chunks, *, k, r2, skip):
    """The plain streaming top-K of one tile ``qt`` [tile, 3]: ``chunks``
    yields the tile's candidate ids in window order; each chunk is merged
    into the running best, held entries first, so the order equals one
    stable sort over the whole window. Returns ([tile, k] d2, [tile, k]
    idx), or empty columns for an empty window."""
    dev = qt.device
    n_pts = points.shape[0]
    r2_t = torch.tensor(np.float32(r2)).to(dev)
    big = torch.tensor(np.float32(_BIG)).to(dev)
    qn = dot3(qt, qt)[:, None]
    best_d2 = torch.full((qt.shape[0], 0), float("inf"), device=dev)
    best_idx = torch.full((qt.shape[0], 0), -1, dtype=torch.int32,
                          device=dev)
    for ids in chunks:
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
    return best_d2, best_idx


def knn_tile_anchored_plain(q, points, dense_flat, anchors, levels, table,
                            *, dims, cap, k, r2, tile):
    """Plain PyTorch version of :func:`knn_tile_anchored`: the same
    elementwise arithmetic, selected by a stable sort.

    Loops over tiles, and over each window in chunks of ``_PLAIN_CHUNK``
    slots, of which only the occupied ones are merged. It reads the levels,
    anchors and table on the host, so it synchronises on CUDA.
    """
    dev = q.device
    n_tiles = anchors.shape[0]
    _, dy, dz = dims
    n_flat = dense_flat.shape[0]
    out_d2 = torch.full((n_tiles * tile, k), float("inf"),
                        dtype=torch.float32, device=dev)
    out_idx = torch.full((n_tiles * tile, k), -1, dtype=torch.int32,
                         device=dev)
    table_h, levels_h, anchors_h = (table.tolist(), levels.tolist(),
                                    anchors.tolist())
    for i in range(n_tiles):
        lvl = levels_h[i]
        if not 0 <= lvl < len(table_h):
            continue
        wx, wy, wz, skip = table_h[lvl]
        ax, ay, az = anchors_h[i]
        m = wx * wy * wz * cap

        def chunks():
            for base in range(0, m, _PLAIN_CHUNK):
                c = torch.arange(base, min(m, base + _PLAIN_CHUNK),
                                 device=dev)
                slot, cell = c % cap, c // cap
                iz, iy, ix = cell % wz, (cell // wz) % wy, cell // (wz * wy)
                flat = ((((ax + ix) * dy + (ay + iy)) * dz + (az + iz)) * cap
                        + slot)
                ids = dense_flat[flat.clamp(0, n_flat - 1)]
                # an empty slot (-1) never enters the list: dropping it
                # keeps the stream's order, so the result is unchanged
                ids = ids[ids >= 0]
                if ids.numel():
                    yield ids

        best_d2, best_idx = _stream_plain(q[i * tile:(i + 1) * tile], points,
                                          chunks(), k=k, r2=r2, skip=skip)
        if best_d2.shape[1]:
            out_d2[i * tile:(i + 1) * tile] = best_d2
            out_idx[i * tile:(i + 1) * tile] = best_idx
    return out_d2, out_idx


def stream_split(m: int, n_units: int, resident: int) -> tuple[int, int]:
    """How the id-stream kernels (``knn_tile``, ``range_count``) cut each
    unit's stream of ``m`` ids: ``(seg, nseg)``, segment s of a unit being
    positions ``[s * seg, min((s + 1) * seg, m))``, every segment holding at
    least one id where ``m > 0`` (one empty segment where ``m == 0``).

    A unit is one row block of one tile (:func:`row_blocks`). There are
    enough segments that the launch's ``n_units * nseg`` work items number
    about ``_ITEMS_PER_CTA`` per CTA the card holds at once (``resident``),
    but none shorter than :data:`STREAM_SEG` unless the whole stream is,
    and one per unit where the units alone fill the card."""
    want = -(-_ITEMS_PER_CTA * resident // n_units)
    nseg = max(1, min(m // STREAM_SEG, want))
    seg = max(1, -(-m // nseg))
    return seg, max(1, -(-m // seg))


_RESIDENT: dict[tuple, int] = {}


def resident_ctas(fn, *args) -> int:
    """CTAs of one kernel launch configuration that the current card holds
    at once (its SM count times the kernel's occupancy), as the library's
    ``<name>_resident(*args, &out)`` entry point ``fn`` reports it; asked
    once per device and arguments."""
    key = (fn.__name__, torch.cuda.current_device(), args)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        err = fn(*args, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"{fn.__name__}: no resident CTA "
                               f"(cudaError {err})")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


@functools.lru_cache(maxsize=None)
def _stream_library():
    from .build import load
    lib = load("knn_tile")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_tile_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                    i, i, i, i, ctypes.c_float, p, p, p, p,
                                    p]
    lib.knn_tile_launch.restype = ctypes.c_int
    lib.knn_tile_resident.argtypes = [i, i, i, i, i, i,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.knn_tile_resident.restype = ctypes.c_int
    return lib


def knn_tile_items(m: int, n_tiles: int, tile: int, k: int
                   ) -> tuple[int, int, int]:
    """How a :func:`knn_tile` call with these shapes splits on the current
    card: ``(n_units, seg, nseg)``, its units (tile, row block), and each
    unit's segments (:func:`stream_split`); ``n_units * nseg`` work items a
    launch."""
    n_rb, rb_rows, block = row_blocks(tile, _STREAM_ROWS)
    kk = min(k, MAX_K)
    resident = resident_ctas(_stream_library().knn_tile_resident, tile,
                             rb_rows, n_rb, block, kk, int(k > MAX_K))
    return (n_tiles * n_rb, *stream_split(m, n_tiles * n_rb, resident))


def knn_tile(
    q: Tensor,            # [n_tiles * tile, 3] f32 queries
    points: Tensor,       # [N, 3] f32 coordinate table
    wnd_idx: Tensor,      # [n_tiles, M] i32 candidate ids (-1 = invalid)
    *,
    k: int,
    r2: float,
    skip_test: bool = False,
    tile: int = 256,
) -> tuple[Tensor, Tensor]:
    """Streaming top-K of each query against its tile's candidate ids, in
    stream order.

    Returns (d2 [Nq, k] f32 ascending, inf-padded; idx [Nq, k] i32,
    -1-padded). Ids are clipped to ``[0, N-1]`` for the gather and -1 ids
    are dropped; candidates beyond ``r2`` are dropped unless
    ``skip_test``; ties keep the earlier stream position.
    """
    n_tiles, m = wnd_idx.shape
    _check_args("knn_tile", q, (
        (q, torch.float32, (n_tiles * tile, 3)),
        (points, torch.float32, (points.shape[0], 3)),
        (wnd_idx, torch.int32, (n_tiles, m)),
    ))
    if points.shape[0] < 1 or k < 1:
        raise ValueError(f"knn_tile: needs points and k >= 1 (k={k})")
    if q.device.type == "cpu":
        return knn_tile_plain(q, points, wnd_idx, k=k, r2=r2,
                              skip_test=skip_test, tile=tile)
    if q.device.type != "cuda":
        raise ValueError(f"knn_tile: no kernel for {q.device}")
    _check_launch("knn_tile", (q, points, wnd_idx), tile)
    if m >= 2 ** 31 or points.shape[0] >= 2 ** 31:
        raise ValueError("knn_tile: stream or points exceed int32")
    rows = n_tiles * tile
    out_d2 = torch.empty((rows, k), dtype=torch.float32, device=q.device)
    out_idx = torch.empty((rows, k), dtype=torch.int32, device=q.device)
    if n_tiles == 0:
        return out_d2, out_idx
    lib = _stream_library()
    n_rb, rb_rows, block = row_blocks(tile, _STREAM_ROWS)
    passes = _passes(k)
    lo_d = lo_p = None
    if len(passes) > 1:   # each query's last key of the pass before
        lo_d = torch.full((rows,), -1.0, dtype=torch.float32,
                          device=q.device)
        lo_p = torch.full((rows,), -1, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        n_units, seg, nseg = knn_tile_items(m, n_tiles, tile, k)
        sync = torch.zeros(2 * n_units, dtype=torch.int32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for col0, kk in passes:
            if col0:
                sync.zero_()
            err = lib.knn_tile_launch(
                q.data_ptr(), points.data_ptr(), wnd_idx.data_ptr(),
                sync.data_ptr(), n_tiles, tile, rb_rows, n_rb, block, m, seg,
                nseg, points.shape[0], kk, k, col0, int(skip_test),
                float(np.float32(r2)),
                None if lo_d is None else lo_d.data_ptr(),
                None if lo_p is None else lo_p.data_ptr(),
                out_d2.data_ptr(), out_idx.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"knn_tile: kernel launch failed "
                                   f"(cudaError {err})")
            knn_tile.launches += 1
    return out_d2, out_idx


knn_tile.launches = 0


def knn_tile_plain(q, points, wnd_idx, *, k, r2, skip_test=False,
                   tile=256):
    """Plain PyTorch version of :func:`knn_tile`: the stream of
    :func:`knn_tile_anchored_plain` over each tile's row of ids."""
    n_tiles, m = wnd_idx.shape
    out_d2 = torch.full((n_tiles * tile, k), float("inf"),
                        dtype=torch.float32, device=q.device)
    out_idx = torch.full((n_tiles * tile, k), -1, dtype=torch.int32,
                         device=q.device)
    for i in range(n_tiles):
        row = wnd_idx[i]
        chunks = (row[b:b + _PLAIN_CHUNK] for b in range(0, m, _PLAIN_CHUNK))
        best_d2, best_idx = _stream_plain(q[i * tile:(i + 1) * tile], points,
                                          chunks, k=k, r2=r2,
                                          skip=skip_test)
        if best_d2.shape[1]:
            out_d2[i * tile:(i + 1) * tile] = best_d2
            out_idx[i * tile:(i + 1) * tile] = best_idx
    return out_d2, out_idx
