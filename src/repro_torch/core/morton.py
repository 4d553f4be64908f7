"""3-D Morton (Z-order) codes of grid-cell coordinates.

10 bits per axis (grids up to 1024^3). The reference packs the 30-bit code
in uint32; PyTorch's uint32 support is partial, so the port holds the same
bits in int64, with the same masks and shifts.
"""
from __future__ import annotations

import torch

from .types import GridSpec, Tensor

_MASKS = (
    (16, 0x030000FF),
    (8, 0x0300F00F),
    (4, 0x030C30C3),
    (2, 0x09249249),
)


def _spread_bits(v: Tensor) -> Tensor:
    """Spread the low 10 bits of ``v`` so consecutive bits are 3 apart."""
    v = v.to(torch.int64) & 0x3FF
    for shift, mask in _MASKS:
        v = (v | (v << shift)) & mask
    return v


def morton_encode(ccoord: Tensor) -> Tensor:
    """Morton code (int64, 30 bits) of integer cell coords [..., 3].

    Coordinates must be in [0, 1024). x is the lowest interleaved bit.
    """
    x = _spread_bits(ccoord[..., 0])
    y = _spread_bits(ccoord[..., 1])
    z = _spread_bits(ccoord[..., 2])
    return x | (y << 1) | (z << 2)


def _compact_bits(v: Tensor) -> Tensor:
    v = v & 0x09249249
    v = (v ^ (v >> 2)) & 0x030C30C3
    v = (v ^ (v >> 4)) & 0x0300F00F
    v = (v ^ (v >> 8)) & 0x030000FF
    v = (v ^ (v >> 16)) & 0x000003FF
    return v


def morton_decode(code: Tensor) -> Tensor:
    """Inverse of :func:`morton_encode`; returns int32 [..., 3]."""
    code = code.to(torch.int64)
    x = _compact_bits(code)
    y = _compact_bits(code >> 1)
    z = _compact_bits(code >> 2)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def morton_sort_key(spec: GridSpec, pos: Tensor) -> Tensor:
    """Sort key: Morton code of the containing cell of ``pos``."""
    return morton_encode(spec.cell_of(pos))


def morton_argsort(spec: GridSpec, pos: Tensor) -> Tensor:
    """Stable permutation (int32) ordering ``pos`` [N, 3] by Morton code."""
    return torch.argsort(morton_sort_key(spec, pos),
                         stable=True).to(torch.int32)
