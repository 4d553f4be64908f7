"""What the inputs of one search call need, whatever the kernel chooses
to do: the in-radius (query, point) pairs, the bytes read and written,
and the least time the card could take. Plain PyTorch over a grid of
cells one radius wide; nothing of the port.

- knn mode: every in-radius pair. A radius-bounded exact knn has to rank
  each of them.
- range mode: the sum over queries of min(k, in-radius count). A bounded
  in-radius subset is all that range mode promises.
- Operations: the pairs times ``OPS_PER_PAIR``.
- Bytes: points and queries read once (3 float32 each), results written
  once (k int32 indices, k float32 distances and one int32 count a query).
- Bound: the larger of operations over the float32 peak outside the
  tensor cores and bytes over the memory bandwidth.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations a (query, point) pair: the dot product q.p (3 mul,
# 2 add), |q|^2 + |p|^2 (1 add), 2 q.p (1 mul), the subtraction, the clamp
# at 0 and the radius test
OPS_PER_PAIR = 10
MAX_PAIRS = 1 << 26        # candidate pairs held at once


def _d2(q, p):
    """The configurations' squared distance, elementwise over pairs."""
    qn = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    pn = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    cross = (q[:, 0] * p[:, 0] + q[:, 1] * p[:, 1]) + q[:, 2] * p[:, 2]
    return torch.clamp_min((qn + pn) - 2 * cross, 0)


def in_radius_counts(points: torch.Tensor, queries: torch.Tensor,
                     radius: float, max_pairs: int = MAX_PAIRS
                     ) -> torch.Tensor:
    """The number of points within ``radius`` of each query (int64 [Q]),
    by the configurations' d2 <= r * r in float32. Candidates come from
    the 27 cells around the query's cell, cells a little over one radius
    wide and binned in float64, so no in-radius point is missed."""
    dev = points.device
    r2 = float(np.float32(radius) * np.float32(radius))
    p64, q64 = points.double(), queries.double()
    lo = torch.minimum(p64.min(0).values, q64.min(0).values)
    width = float(radius) * (1 + 1e-6)
    pc = torch.floor((p64 - lo) / width).long()
    qc = torch.floor((q64 - lo) / width).long()
    dims = torch.maximum(pc.max(0).values, qc.max(0).values) + 1
    dx, dy, dz = (int(v) for v in dims.tolist())

    def flat(c):
        return (c[:, 0] * dy + c[:, 1]) * dz + c[:, 2]

    order = torch.argsort(flat(pc))
    sp = points[order]
    starts = torch.searchsorted(flat(pc)[order], torch.arange(
        dx * dy * dz + 1, device=dev))
    counts = torch.zeros(queries.shape[0], dtype=torch.int64, device=dev)
    hi = dims - 1
    for off in itertools.product((-1, 0, 1), repeat=3):
        nc = qc + torch.tensor(off, device=dev)
        valid = ((nc >= 0) & (nc <= hi)).all(1)
        f = flat(torch.minimum(nc.clamp_min(0), hi))
        s = starts[f]
        lens = torch.where(valid, starts[f + 1] - s, 0)
        cum = np.cumsum(lens.cpu().numpy())
        a = 0
        while a < len(cum):
            base = cum[a - 1] if a else 0
            b = max(int(np.searchsorted(cum, base + max_pairs, "right")),
                    a + 1)
            ln = lens[a:b]
            tot = int(cum[b - 1] - base)
            if tot:
                qi = torch.repeat_interleave(
                    torch.arange(a, b, device=dev), ln, output_size=tot)
                first = torch.cumsum(ln, 0) - ln
                pos = (torch.arange(tot, device=dev)
                       - torch.repeat_interleave(first, ln, output_size=tot)
                       + torch.repeat_interleave(s[a:b], ln,
                                                 output_size=tot))
                inr = _d2(queries[qi], sp[pos]) <= r2
                counts.index_add_(0, qi, inr.to(torch.int64))
            a = b
    return counts


def call_work(points: torch.Tensor, queries: torch.Tensor, radius: float,
              k: int, mode: str) -> dict:
    """Pairs, operations, bytes and the bound of one call's inputs."""
    counts = in_radius_counts(points, queries, radius)
    pairs = int(counts.sum() if mode == "knn"
                else torch.clamp_max(counts, k).sum())
    nq = queries.shape[0]
    nbytes = points.shape[0] * 12 + nq * 12 + nq * k * 8 + nq * 4
    ops = pairs * OPS_PER_PAIR
    return dict(pairs=pairs, ops=ops, bytes=nbytes,
                bound_s=max(ops / PEAK_FP32, nbytes / PEAK_BYTES),
                bound_by="operations" if ops / PEAK_FP32
                >= nbytes / PEAK_BYTES else "bytes")
