"""Per-query range counting over pre-gathered candidate windows.

:func:`range_count` is the port of the reference's Pallas kernel of the
same name (``src/repro/kernels/range_tile.py``): per query, the number of
its tile's window candidates with an id >= 0 and
``d2 = max(|q|^2 + |p|^2 - 2 q.p, 0) <= r2`` (the paper's Step-2 counter,
the counting half of bounded range search). On a CUDA tensor it launches
the hand-written kernel ``csrc/range_count.cu`` (built by
``kernels/build.py``); on a CPU tensor it runs :func:`range_count_plain`,
the same arithmetic in plain PyTorch. There is no fallback from one to the
other. The kernel cuts each tile's stream into work items across a grid
that fills the card (``knn_tile.stream_split``), reads the position of a
valid id only, and adds each item's integer partial counts into a zeroed
output, exact in any order.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .knn_tile import (_PLAIN_CHUNK, _check_args, _check_launch,
                       resident_ctas, row_blocks, stream_split)
from .ref import dot3

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    lib = load("range_count")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.range_count_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                       ctypes.c_float, p, p]
    lib.range_count_launch.restype = ctypes.c_int
    lib.range_count_resident.argtypes = [i, i, i, i,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.range_count_resident.restype = ctypes.c_int
    return lib


def range_count_items(m: int, n_tiles: int, tile: int
                      ) -> tuple[int, int, int]:
    """How a :func:`range_count` call with these shapes splits on the
    current card: ``(n_units, seg, nseg)``, its units (tile, row block),
    and each unit's segments (``knn_tile.stream_split``); ``n_units *
    nseg`` work items a launch."""
    n_rb, rb_rows, block = row_blocks(tile)
    resident = resident_ctas(_library().range_count_resident, tile,
                             rb_rows, n_rb, block)
    return (n_tiles * n_rb, *stream_split(m, n_tiles * n_rb, resident))


def range_count(
    q: Tensor,            # [n_tiles * tile, 3] f32 queries
    wnd_pos: Tensor,      # [n_tiles, M, 3] f32 candidate positions
    wnd_idx: Tensor,      # [n_tiles, M] i32 candidate ids (-1 = invalid)
    *,
    r2: float,
    tile: int = 256,
) -> Tensor:
    """Per-query count [Nq] int32 of its tile's candidates within
    ``sqrt(r2)``; exact and deterministic."""
    n_tiles, m = wnd_idx.shape
    _check_args("range_count", q, (
        (q, torch.float32, (n_tiles * tile, 3)),
        (wnd_pos, torch.float32, (n_tiles, m, 3)),
        (wnd_idx, torch.int32, (n_tiles, m)),
    ))
    if q.device.type == "cpu":
        return range_count_plain(q, wnd_pos, wnd_idx, r2=r2, tile=tile)
    if q.device.type != "cuda":
        raise ValueError(f"range_count: no kernel for {q.device}")
    _check_launch("range_count", (q, wnd_pos, wnd_idx), tile)
    if m >= 2 ** 31:
        raise ValueError("range_count: window exceeds int32")
    out = torch.zeros((n_tiles * tile,), dtype=torch.int32, device=q.device)
    if n_tiles == 0:
        return out
    lib = _library()
    n_rb, rb_rows, block = row_blocks(tile)
    with torch.cuda.device(q.device):
        _, seg, nseg = range_count_items(m, n_tiles, tile)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.range_count_launch(
            q.data_ptr(), wnd_pos.data_ptr(), wnd_idx.data_ptr(), n_tiles,
            tile, rb_rows, n_rb, block, m, seg, nseg, float(np.float32(r2)),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"range_count: kernel launch failed (cudaError "
                           f"{err})")
    range_count.launches += 1
    return out


range_count.launches = 0


def range_count_plain(q, wnd_pos, wnd_idx, *, r2, tile=256):
    """Plain PyTorch version of :func:`range_count`: the same elementwise
    arithmetic, tile by tile, in chunks of candidates."""
    n_tiles, m = wnd_idx.shape
    r2_t = torch.tensor(np.float32(r2)).to(q.device)
    out = torch.zeros((n_tiles * tile,), dtype=torch.int32, device=q.device)
    for i in range(n_tiles):
        qt = q[i * tile:(i + 1) * tile]
        qn = dot3(qt, qt)[:, None]
        for b in range(0, m, _PLAIN_CHUNK):
            p = wnd_pos[i, b:b + _PLAIN_CHUNK]
            pn = dot3(p, p)[None, :]
            cross = dot3(qt[:, None, :], p[None, :, :])
            d2 = torch.clamp_min(qn + pn - 2.0 * cross, 0.0)
            hit = (d2 <= r2_t) & (wnd_idx[i, b:b + _PLAIN_CHUNK] >= 0)[None]
            out[i * tile:(i + 1) * tile] += hit.sum(-1, dtype=torch.int32)
    return out
