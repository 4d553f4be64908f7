"""Plain PyTorch oracles: the brute-force neighbor search the whole port is
validated against, and the selection helpers it shares.

Distances use the expanded form ``|q|^2 + |p|^2 - 2 q.p`` clamped at 0, as
the reference does. Each of the three sums is written out x, then y, then
z, instead of a matmul or ``.sum(-1)``, so its rounding does not depend on
a library's reduction order and agrees with the CUDA kernel's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """x, y, z products summed in that order over the last axis [..., 3]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sq_dist(a: Tensor, b: Tensor) -> Tensor:
    """Squared distance over the last axis [..., 3]: ``d = a - b``, then
    ``dot3(d, d)``, the squares summed x, y, z in that order."""
    d = a - b
    return dot3(d, d)


def pairwise_d2(q: Tensor, p: Tensor) -> Tensor:
    """Squared Euclidean distances [Nq, Np] between q [Nq, 3] and p [Np, 3]."""
    qn = dot3(q, q)[:, None]                              # [Nq, 1]
    pn = dot3(p, p)[None, :]                              # [1, Np]
    cross = (q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1]
             + q[:, None, 2] * p[None, :, 2])              # [Nq, Np]
    return torch.clamp_min(qn + pn - 2.0 * cross, 0.0)


def topk_select(d2: Tensor, idx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Smallest-k selection along the last axis, ties in position order.

    ``d2`` [..., M] (inf = invalid), ``idx`` [..., M] (-1 = invalid).
    Returns ([..., k] d2, [..., k] idx), ascending, padded with (inf, -1).
    """
    m = d2.shape[-1]
    if m < k:
        pad_shape = (*d2.shape[:-1], k - m)
        d2 = torch.cat([d2, d2.new_full(pad_shape, float("inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_full(pad_shape, -1)], dim=-1)
    order = torch.argsort(d2, dim=-1, stable=True)[..., :k]
    d2s = torch.gather(d2, -1, order)
    idxs = torch.gather(idx, -1, order)
    idxs = torch.where(torch.isinf(d2s), -1, idxs)
    return d2s, idxs


def brute_force_search(points: Tensor, queries: Tensor, radius: float,
                       k: int, mode: str = "knn", chunk: int = 512
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """Exhaustive oracle. Returns (idx [Nq,k] int32, d2 [Nq,k] f32,
    counts [Nq] int32).

    Both modes return the *nearest* k within ``radius``. ``chunk`` queries
    are searched at a time, so memory stays at ``chunk x N``.
    """
    del mode          # both modes are nearest-k within the radius
    nq = queries.shape[0]
    r2 = torch.tensor(np.float32(radius) * np.float32(radius),
                      dtype=torch.float32).to(points.device,
                                              non_blocking=True)
    cand_idx = torch.arange(points.shape[0], dtype=torch.int32,
                            device=points.device)
    outs_i, outs_d, outs_c = [], [], []
    for s in range(0, nq, chunk):
        d2 = pairwise_d2(queries[s:s + chunk], points)
        d2 = torch.where(d2 <= r2, d2, float("inf"))
        idx = torch.where(torch.isinf(d2), -1, cand_idx[None, :])
        d2k, idxk = topk_select(d2, idx, k)
        outs_d.append(d2k)
        outs_i.append(idxk)
        outs_c.append(torch.sum(~torch.isinf(d2k), dim=-1).to(torch.int32))
    if not outs_i:
        dev = points.device
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    return torch.cat(outs_i), torch.cat(outs_d), torch.cat(outs_c)


def streaming_topk_ref(d2_tiles: Tensor, idx_tiles: Tensor, k: int
                       ) -> tuple[Tensor, Tensor]:
    """Top-k over the flattened candidate axes of [T, n_tiles, tile_m]."""
    t = d2_tiles.shape[0]
    return topk_select(d2_tiles.reshape(t, -1), idx_tiles.reshape(t, -1), k)


def range_count_ref(q: Tensor, p: Tensor, radius: float) -> Tensor:
    """Number of points within ``radius`` per query (int32)."""
    d2 = pairwise_d2(q, p)
    return torch.sum(d2 <= radius ** 2, dim=-1).to(torch.int32)
