"""Spatially-ordered query scheduling (paper section 4).

A query's first-hit "AABB" is its containing grid cell, available in
closed form, so scheduling is a Morton sort of cell coordinates. Every sort
here is stable: ``jnp.argsort`` is stable by default and ``torch.argsort``
is not, and Morton codes tie whenever queries share a cell.
"""
from __future__ import annotations

import torch

from .morton import morton_encode
from .types import GridSpec, Tensor


def schedule_queries(spec: GridSpec, queries: Tensor) -> tuple[Tensor, Tensor]:
    """Return (perm, inv_perm) ordering ``queries`` [Nq, 3] spatially.

    ``perm`` maps scheduled slot -> original query index; ``inv_perm`` maps
    original index -> scheduled slot.
    """
    return schedule_cells(spec.cell_of(queries))


def schedule_cells(ccoord: Tensor) -> tuple[Tensor, Tensor]:
    """Schedule from precomputed integer cell coordinates [Nq, 3]."""
    perm = torch.argsort(morton_encode(ccoord), stable=True).to(torch.int32)
    n = ccoord.shape[0]
    inv = torch.empty((n,), dtype=torch.int32, device=ccoord.device)
    inv[perm.long()] = torch.arange(n, dtype=torch.int32,
                                    device=ccoord.device)
    return perm, inv


def schedule_by_level(ccoord: Tensor, levels: Tensor,
                      morton: bool = True) -> Tensor:
    """``(level, Morton)`` lexicographic ordering (int32 permutation).

    Queries are Morton-scheduled first, then stably sorted by their
    launch-signature level, so every level is a contiguous run of scheduled
    slots that keeps the Morton order within itself. ``morton=False``
    mirrors ``SearchOpts(schedule=False)`` (input order within each level).
    """
    n = ccoord.shape[0]
    if morton:
        perm0 = torch.argsort(morton_encode(ccoord),
                              stable=True).to(torch.int32)
    else:
        perm0 = torch.arange(n, dtype=torch.int32, device=ccoord.device)
    order = torch.argsort(levels[perm0.long()], stable=True)
    return perm0[order]


def coherence_statistic(spec: GridSpec, queries: Tensor) -> Tensor:
    """Fraction of adjacent query pairs sharing a grid cell."""
    flat = spec.flat_cell(spec.cell_of(queries))
    return (flat[1:] == flat[:-1]).to(torch.float32).mean()
