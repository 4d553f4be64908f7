"""Core datatypes of the PyTorch port of the RTNN neighbor search library.

Static-shape discipline as in the JAX package: everything that determines
a tensor shape (grid dims, cell capacity, K, window radius, tile sizes) is
a Python int held in a frozen, hashable spec object; everything
data-dependent (point positions, counts, permutations) lives in tensors.

Dtypes follow the reference: indices and counts are int32, distances
float32. ``torch.sort``/``argsort``/``searchsorted`` return int64, so the
port casts their results back to int32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

# Padding convention of the sharded slabs: rows "parked" at PARK_SENTINEL
# are empty slots of a fixed-capacity buffer. Any position with a coordinate
# magnitude >= PARK_THRESHOLD is treated as parked when
# ``SearchOpts.mask_parked`` is set: dropped from the grid entirely.
PARK_SENTINEL = 1e30
PARK_THRESHOLD = 1e29


def device_table(values, dtype: torch.dtype, device) -> Tensor:
    """A small host-static table (ladders, dims, origins) on ``device``.

    The copy is issued ``non_blocking``: from pageable memory the driver
    stages the bytes before returning, so it is safe, and it is not a
    host synchronisation (the planning path runs under
    ``torch.cuda.set_sync_debug_mode("error")`` in the chip check).
    """
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    return t.to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a uniform cell grid over the point domain.

    Points are binned into cells of edge ``cell_size``; a search with window
    radius ``w`` (in cells) gathers the ``(2w+1)**3`` cell neighborhood.
    """

    origin: tuple[float, float, float]
    cell_size: float
    dims: tuple[int, int, int]          # number of cells per axis (static)
    capacity: int                        # max points stored per cell (static)

    @property
    def num_cells(self) -> int:
        dx, dy, dz = self.dims
        return dx * dy * dz

    def cell_of(self, pos: Tensor, origin: Tensor | None = None) -> Tensor:
        """Integer cell coordinates (int32) of positions ``pos`` [..., 3].

        The cell size is divided as a 0-d float32 tensor on ``pos``'s
        device, never as a Python float: CUDA divides a tensor by a CPU
        scalar as a multiply by the reciprocal, which moves ``floor`` at
        cell boundaries away from numpy/JAX's true division. The floor is
        clamped to the grid while still float, which equals the reference's
        saturating int32 cast followed by its clip.
        """
        dev = pos.device
        o = (device_table(self.origin, torch.float32, dev) if origin is None
             else origin.to(torch.float32))
        cs = device_table(np.float32(self.cell_size), torch.float32, dev)
        c = torch.floor((pos - o) / cs)
        hi = device_table([d - 1 for d in self.dims], torch.float32, dev)
        return torch.minimum(c.clamp_min(0.0), hi).to(torch.int32)

    def flat_cell(self, ccoord: Tensor) -> Tensor:
        """Flatten [..., 3] integer cell coords to a scalar cell id."""
        _, dy, dz = self.dims
        return (ccoord[..., 0] * dy + ccoord[..., 1]) * dz + ccoord[..., 2]


@dataclasses.dataclass
class CellGrid:
    """The built acceleration structure.

    ``dense``    [Dx, Dy, Dz, C]  int32 point indices, -1 padded.
    ``counts``   [Dx, Dy, Dz]     int32 points per cell (clipped to C).
    ``sat``      [Dx+1, Dy+1, Dz+1] int32 3-D summed-area table of counts.
    ``overflow`` 0-d int32: points dropped because their cell was full.
    """

    spec: GridSpec
    dense: Tensor
    counts: Tensor
    sat: Tensor
    overflow: Tensor


@dataclasses.dataclass
class UpdateStats:
    """Counters of one incremental grid update (0-d tensors): ``overflow``,
    ``oob`` (points whose true cell lies outside the frozen grid) and
    ``max_disp2`` (max squared displacement vs the plan-anchor positions).
    """

    overflow: Tensor
    oob: Tensor
    max_disp2: Tensor


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static parameters of one neighbor search call."""

    radius: float
    k: int
    mode: str = "knn"                  # "knn" | "range"
    knn_window: str = "heuristic"      # "heuristic" | "exact" (paper 5.1)


@dataclasses.dataclass
class SearchResult:
    """indices [Nq, K] int32 (-1 pad), distances2 [Nq, K] f32 (inf pad),
    counts [Nq] int32."""

    indices: Tensor
    distances2: Tensor
    counts: Tensor


@dataclasses.dataclass(frozen=True)
class SearchOpts:
    """Which paper optimizations are enabled; the same fields as the JAX
    package's ``SearchOpts``, so one options object converts 1:1.

    ``use_pallas`` keeps its name for that reason. In this port it selects
    the fused hand-written kernel path: ``kernels/ops.window_search_segmented``
    launching the CUDA kernel ``knn_tile_anchored`` (its plain PyTorch
    version on CPU tensors). False selects the plain per-tile tensor path
    of ``core/search.window_tile_search``.
    """

    schedule: bool = True              # section 4: Morton query ordering
    partition: bool = True             # section 5.1: megacell partitioning
    bundle: bool = True                # section 5.2: cost-model bundling
    use_pallas: bool = False           # fused hand-written kernel path
    query_tile: int = 256              # queries per tile / CTA
    w_max: int = 6                     # max megacell growth rings examined
    executor: bool = True              # host-planned executor path
    w_ladder: tuple[int, ...] | None = None
    #                                    explicit window ladder: queries round
    #                                    UP to the nearest ladder window
    #                                    (always exact, sphere test always on)
    mask_parked: bool = False          # rows parked at PARK_SENTINEL are
    #                                    dropped from the grid
