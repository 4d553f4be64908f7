"""Fused re-binning + motion statistics for dynamic scenes.

:func:`bin_disp_tile` is the port of the reference's Pallas kernel of the
same name (``src/repro/kernels/update_tile.py``). One pass over the moved
points gives what the incremental grid update needs: the clipped integer
cell of every point, the number of points whose true cell left the frozen
grid, and the largest squared displacement against the plan-anchor
positions. On a CUDA tensor it launches the hand-written kernel
``csrc/bin_disp_tile.cu`` (built by ``kernels/build.py``); on a CPU tensor
it runs :func:`bin_disp_tile_plain`, the same arithmetic in plain PyTorch.
There is no fallback from one to the other.

Both versions bin as the Pallas kernel does, by multiplying with the
float32 reciprocal of the cell size, ``floor((p - o) * f32(1 / cell))``.
``core/grid._bin_and_stats`` divides instead, as ``GridSpec.cell_of``
does, and a point on a cell boundary can land in the neighbouring cell
depending on the formula; each port path follows its own reference path.
The squared displacement is ``kernels/ref.sq_dist``: the three squares
summed x, y, z in that order, in float32.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.types import PARK_THRESHOLD, device_table
from .ref import sq_dist

Tensor = torch.Tensor


def _check(points, anchor_points, origin):
    for name, t in (("points", points), ("anchor_points", anchor_points)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"bin_disp_tile: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 [N, 3]")
    if anchor_points.shape != points.shape:
        raise ValueError(
            f"bin_disp_tile: anchor_points {tuple(anchor_points.shape)} "
            f"!= points {tuple(points.shape)}")
    tensors = [points, anchor_points]
    if origin is not None:
        if origin.dtype != torch.float32 or origin.numel() != 3:
            raise ValueError(f"bin_disp_tile: origin is {origin.dtype} "
                             f"{tuple(origin.shape)}, expected float32 [3]")
        tensors.append(origin)
    for t in tensors:
        if t.device != points.device:
            raise ValueError("bin_disp_tile: tensors on different devices "
                             f"({t.device} vs {points.device})")


def _inv_cell(spec) -> np.float32:
    """The multiplier of the Pallas kernel: the float64 reciprocal of the
    cell size rounded to float32."""
    return np.float32(1.0 / spec.cell_size)


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    lib = load("bin_disp_tile")
    fn = lib.bin_disp_tile_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def launch(points, anchor_points, origin, inv_cell, dims, mask_parked,
           ccoord, stats) -> None:
    """One launch of the CUDA kernel into caller-made outputs: ``ccoord``
    [N, 3] i32 and ``stats`` [2] i32 zeroed (oob count, max_disp2 bits).
    No checks and no count; :func:`bin_disp_tile` is the checked entry."""
    n = points.shape[0]
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = _library()(points.data_ptr(), anchor_points.data_ptr(),
                         origin.data_ptr(), float(inv_cell), dims[0],
                         dims[1], dims[2], n, int(bool(mask_parked)),
                         ccoord.data_ptr(), stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bin_disp_tile: kernel launch failed "
                           f"(cudaError {err})")


def bin_disp_tile(
    points: Tensor,            # [N, 3] f32 moved positions
    anchor_points: Tensor,     # [N, 3] f32 positions of the captured plan
    spec,                      # core.types.GridSpec
    *,
    origin: Tensor | None = None,
    mask_parked: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused binning + stats of ``points`` against ``anchor_points``.

    Returns ``(ccoord [N, 3] int32 clipped, oob int32 0-d, max_disp2 f32
    0-d)``, all on ``points``' device and without a host synchronisation.
    ``origin`` [3] overrides the spec origin; ``mask_parked`` leaves rows
    with any ``|coord| >= PARK_THRESHOLD`` out of both statistics.
    """
    _check(points, anchor_points, origin)
    if points.device.type == "cpu":
        return bin_disp_tile_plain(points, anchor_points, spec,
                                   origin=origin, mask_parked=mask_parked)
    if points.device.type != "cuda":
        raise ValueError(f"bin_disp_tile: no kernel for {points.device}")
    if points.shape[0] >= 2 ** 31 // 3:
        raise ValueError("bin_disp_tile: too many points for int32 offsets")
    o = (device_table(spec.origin, torch.float32, points.device)
         if origin is None else origin.reshape(3))
    for t in (points, anchor_points, o):
        if not t.is_contiguous():
            raise ValueError("bin_disp_tile: tensors must be contiguous")
    n = points.shape[0]
    ccoord = torch.empty((n, 3), dtype=torch.int32, device=points.device)
    stats = torch.zeros((2,), dtype=torch.int32, device=points.device)
    if n:
        launch(points, anchor_points, o, _inv_cell(spec), tuple(spec.dims),
               mask_parked, ccoord, stats)
        bin_disp_tile.launches += 1
    return ccoord, stats[0], stats[1].view(torch.float32)


bin_disp_tile.launches = 0


def bin_disp_tile_plain(points, anchor_points, spec, *, origin=None,
                        mask_parked=False):
    """Plain PyTorch version of :func:`bin_disp_tile`: the same elementwise
    arithmetic. The floor is compared with the grid bounds and clamped
    while still float, which equals the reference's saturating int32 cast
    followed by its comparison and clip."""
    dev = points.device
    o = (device_table(spec.origin, torch.float32, dev) if origin is None
         else origin.to(torch.float32).reshape(3))
    inv = device_table(_inv_cell(spec), torch.float32, dev)
    hi = device_table([d - 1 for d in spec.dims], torch.float32, dev)
    c = torch.floor((points - o) * inv)
    escaped = torch.any((c < 0) | (c > hi), dim=-1)
    d2 = sq_dist(points, anchor_points)
    if mask_parked:
        real = ~torch.any(points.abs() >= PARK_THRESHOLD, dim=-1)
        escaped = escaped & real
        d2 = torch.where(real, d2, 0.0)
    oob = torch.sum(escaped, dtype=torch.int32)
    max_d2 = (torch.max(d2) if d2.numel()
              else torch.zeros((), dtype=torch.float32, device=dev))
    return torch.minimum(c.clamp_min(0.0), hi).to(torch.int32), oob, max_d2
