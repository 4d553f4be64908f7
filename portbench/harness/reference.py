"""The plain reference: brute-force neighbor search over every point, in
plain PyTorch, on the rows that a run compares.

It imports nothing of the port. The squared distance is the one that the
configurations state: d2 = max((|q|^2 + |p|^2) - 2 q.p, 0), each dot
product summed x, then y, then z, every operation rounded on its own (no
fused multiply-add: each is a separate tensor operation), and a point is
within the radius when d2 <= r * r, both rounded to float32. A knn row is
the k smallest such d2 within the radius; a range row is any min(k, n)
distinct points of the n within it.

``control_rows`` is the same search computed in bfloat16, the precision
below the configurations' float32: it stands in the program's place to
show that the comparison in ``check`` fails it.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 256


def radius2(radius: float, dtype=torch.float32) -> float:
    """r * r as the configurations round it: in float32, then to ``dtype``."""
    r2 = float(np.float32(radius) * np.float32(radius))
    return float(torch.tensor(r2, dtype=dtype))


def _dot3(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def d2_block(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances [m, N] of queries q [m, 3] to points p [N, 3] in
    their dtype, in the configurations' order of operations."""
    qn = _dot3(q, q)
    pn = _dot3(p, p)
    cross = (q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1]) \
        + q[:, None, 2] * p[None, :, 2]
    return torch.clamp_min((qn[:, None] + pn[None, :]) - 2 * cross, 0)


def control_rows(points: torch.Tensor, queries: torch.Tensor, radius: float,
                 k: int, mode: str, dtype=torch.bfloat16):
    """The reference's answer for ``queries`` computed in ``dtype``: (idx
    [m, k] int32, d2 [m, k] float32, counts [m] int32), padded with -1 and
    inf, as the program returns it."""
    n = points.shape[0]
    p = points.to(dtype)
    r2 = radius2(radius, dtype)
    outs = []
    for s in range(0, queries.shape[0], BLOCK_ROWS):
        d = d2_block(queries[s:s + BLOCK_ROWS].to(dtype), p)
        inr = d <= r2
        kk = min(k, n)
        if mode == "knn":
            key = torch.where(inr, d, torch.full_like(d, float("inf")))
            val, ids = torch.topk(key.float(), kk, dim=1, largest=False)
        else:
            pos = torch.arange(n, device=d.device).expand_as(d)
            key = torch.where(inr, pos, torch.full_like(pos, n))
            ids = torch.topk(key, kk, dim=1, largest=False).indices
            val = torch.gather(d, 1, ids).float()
            val = torch.where(torch.gather(inr, 1, ids), val,
                              torch.full_like(val, float("inf")))
        cnt = torch.clamp_max(inr.sum(1), k).to(torch.int32)
        idx = torch.where(torch.isinf(val), -1, ids).to(torch.int32)
        if kk < k:
            pad = (val.shape[0], k - kk)
            val = torch.cat([val, val.new_full(pad, float("inf"))], 1)
            idx = torch.cat([idx, idx.new_full(pad, -1)], 1)
        outs.append((idx, val, cnt))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs]))


def compare_rows(points: torch.Tensor, queries: torch.Tensor, idx, d2, cnt,
                 radius: float, k: int, mode: str) -> dict:
    """The program's rows (idx [m, k], d2 [m, k], counts [m]) for
    ``queries`` [m, 3] against brute force over ``points`` [N, 3]:

    - ``count_rows_off``: rows whose count is not min(k, points within r);
    - ``slots_off``: slots below the count whose index is out of range, a
      repeat in its row, outside the radius, or whose d2 is not the
      reference's d2 of that pair, bit for bit; and slots at or past the
      count not padded with (-1, inf);
    - ``knn_d2_gap`` (knn): the largest gap between the row's d2, sorted,
      and the reference's k smallest, over the slots both hold.
    """
    n = points.shape[0]
    r2 = radius2(radius)
    count_off = slots_off = 0
    gap = 0.0
    slot = torch.arange(k, device=points.device)
    for s in range(0, queries.shape[0], BLOCK_ROWS):
        d = d2_block(queries[s:s + BLOCK_ROWS], points)
        inr = d <= r2
        want = torch.clamp_max(inr.sum(1), k)
        c = cnt[s:s + BLOCK_ROWS].to(torch.int64)
        count_off += int((c != want).sum())
        ix = idx[s:s + BLOCK_ROWS].to(torch.int64)
        dp = d2[s:s + BLOCK_ROWS].to(torch.float32)
        used = slot[None, :] < c[:, None]
        in_range = (ix >= 0) & (ix < n)
        dref = torch.gather(d, 1, ix.clamp(0, n - 1))
        good = in_range & (dref <= r2) & (dref == dp)
        # a repeated index among the used slots: unused slots get distinct
        # negative keys so they never match
        keyed = torch.where(used, ix, -1 - slot[None, :])
        srt = torch.sort(keyed, dim=1).values
        rep = torch.zeros_like(used)
        rep[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        padded = (ix == -1) & torch.isinf(dp) & (dp > 0)
        slots_off += int((used & ~good).sum()) + int(rep.sum()) \
            + int((~used & ~padded).sum())
        if mode == "knn":
            inf = torch.full_like(d, float("inf"))
            top = torch.topk(torch.where(inr, d, inf), min(k, n), dim=1,
                             largest=False).values
            mine = torch.sort(torch.where(used, dp, torch.full_like(
                dp, float("inf"))), dim=1).values[:, :top.shape[1]]
            both = (slot[None, :top.shape[1]]
                    < torch.minimum(c, want)[:, None])
            if bool(both.any()):
                gap = max(gap, float((mine - top).abs()[both].max()))
    out = dict(count_rows_off=count_off, slots_off=slots_off)
    if mode == "knn":
        out["knn_d2_gap"] = gap
    return out
