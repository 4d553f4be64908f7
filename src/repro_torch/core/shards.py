"""Sharded scenes: slab-resident sessions on the functional core (the
reference's ``core/shards.py`` in eager PyTorch).

The scene is cut into equal-width x-slabs. Each slab keeps its rows in a
fixed-capacity buffer (``point_cap`` owned rows, parked at
``PARK_SENTINEL`` with id -1 when empty), shares one static ``GridSpec``
with every other slab and differs only in its frame (``origin_of``: the
spec origin shifted by ``slab * slab_width`` along x).

Where the reference runs one device per slab under ``shard_map`` and
exchanges rows with ``ppermute``, the port runs a contiguous block of
slabs in each process (``launch/mesh.py``: all of them without a rank
layout, ``S / R`` on each of ``R`` ranks with one), with the slab axis
as the leading tensor dimension:

* ``pts [S_r, P, 3]`` and ``ids [S_r, P]`` are the rank's rows of the
  reference's global arrays, slab ids global (``_slab_ids``);
* a ``ppermute`` to the right or left neighbor is a shift along that axis
  inside the block; the slot at the block's edge comes from the
  neighbouring rank's edge slab by ``batch_isend_irecv`` (payloads at the
  static per-face caps, so no sizes travel), and is zeros at the mesh
  edge, which is what ``ppermute`` gives a device with no source (hence
  ``_pack``'s ids shifted by +1);
* routing is of the whole input on every rank, each keeping its block;
  halo exchange and migration are batched over the block; the per-slab
  search is a Python loop over the rank's slabs that calls
  ``api.build_index`` / ``update_index`` / ``plan_query`` /
  ``execute_plan`` with the slab's origin, and the per-slab results are
  gathered over the ranks (one ``all_gather`` an axis) before the inverse
  scatter, so every rank returns the whole result.

Scatters that the reference drops out of range (``mode="drop"``) write to
a dump row past the end that is sliced off: only the dump row ever takes
duplicate indices (an out-of-range ``index_put_`` is a device assert on
CUDA, and duplicate indices write in no fixed order). Row selection is a
stable argsort and a gather at a static cap, never boolean indexing,
which would synchronise with the host.

:class:`ShardedSession` steps the slabs with one blocking transfer a step
(two when the layout is exhausted and the scene is re-routed), as the
port's ``SimulationSession`` does: the telemetry vector carries a per-slab
stale tail, so the host makes the reference's per-slab ``lax.cond``
(replan or replay) for each slab. Across ranks its header is reduced on
the device before that fetch (flags and staleness by max, counters by
sum), so every rank takes the same branch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import obs
from ..obs.device import TELEM_DISP_BITS, TELEM_FLAGS
from . import api
from .dynamic import SessionOpts, _host_points, validate_session_opts
from .types import (PARK_SENTINEL, GridSpec, SearchOpts, SearchParams,
                    SearchResult, Tensor, device_table)

_FLAG_REPLANNED = 1     # some slab's staleness test chose the replan
_FLAG_EXHAUSTED = 2     # a cap overflowed: layout can no longer hold scene


@dataclasses.dataclass(frozen=True)
class ShardOpts:
    """Static knobs of the slab decomposition (the reference's fields).

    The ``*_slack`` factors size the fixed-capacity per-slab buffers above
    the observed distribution so rows can migrate and drift between host
    re-routes; ``migrate_frac`` caps the per-face per-step migration
    volume. ``reroute_growth`` is the hysteresis of the host fallback:
    every re-route multiplies all headroom by the accumulated boost
    (capped at ``reroute_boost_max``).
    """

    point_slack: float = 1.6
    halo_slack: float = 1.6
    migrate_frac: float = 0.2
    query_slack: float = 1.5
    capacity_slack: float = 1.5
    domain_margin_radii: float = 1.0
    max_dim: int = 128
    auto_reroute: bool = True
    reroute_growth: float = 2.0
    reroute_boost_max: float = 64.0


# the one-shot path (distributed_neighbor_search) decomposes a STATIC
# scene: exact caps, no drift headroom
STATIC_SCENE_OPTS = ShardOpts(point_slack=1.0, halo_slack=1.0,
                              query_slack=1.0, capacity_slack=1.0,
                              domain_margin_radii=0.0)


def _f32(value, device) -> Tensor:
    return device_table(np.float32(value), torch.float32, device)


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Host-planned static layout of the spatial decomposition.

    ``spec`` is the one grid spec every slab shares; ``spec.origin`` is
    slab 0's frame and :meth:`origin_of` shifts it per slab. The methods
    take slab ids or coordinates as tensors and compute in float32 on
    their device, with 0-d device tensors for the layout's constants.
    """

    n_slabs: int
    n_qsplit: int
    lo_x: float
    slab_width: float
    halo: float             # world-units halo width (= search radius)
    point_cap: int          # owned-row slots per slab
    halo_cap: int           # per-face halo-exchange payload rows
    migrate_cap: int        # per-face per-step migration payload rows
    query_cap: int          # rows per (slab, qsplit) routing cell
    spec: GridSpec

    @property
    def total_rows(self) -> int:
        """Rows of the halo-extended per-slab point buffer."""
        return self.point_cap + 2 * self.halo_cap

    def origin_of(self, sidx: Tensor) -> Tensor:
        """Local grid origins [..., 3] of slabs ``sidx``."""
        dev = sidx.device
        ox = (_f32(self.spec.origin[0], dev)
              + sidx.to(torch.float32) * _f32(self.slab_width, dev))
        rest = [_f32(o, dev).expand_as(ox) for o in self.spec.origin[1:]]
        return torch.stack([ox, *rest], dim=-1)

    def slab_of(self, x: Tensor) -> Tensor:
        """Slab ids (int32) of x-coordinates, clipped to the edge slabs.
        The floor is clamped while still float, which equals the
        reference's saturating cast followed by its clip."""
        dev = x.device
        s = torch.floor((x - _f32(self.lo_x, dev))
                        / _f32(self.slab_width, dev))
        return s.clamp(0, self.n_slabs - 1).to(torch.int32)

    def slab_bounds(self, sidx: Tensor) -> tuple[Tensor, Tensor]:
        dev = sidx.device
        width = _f32(self.slab_width, dev)
        lo = _f32(self.lo_x, dev) + sidx.to(torch.float32) * width
        return lo, lo + width


def plan_layout(points, params: SearchParams, n_slabs: int, *,
                n_qsplit: int = 1, queries=None,
                shopts: ShardOpts = ShardOpts(),
                cell_size: float | None = None,
                boost: float = 1.0) -> SlabLayout:
    """Host-side planning of the slab decomposition (numpy, as the
    reference's).

    Equal-width x-slabs over the (margin-padded) point extent; the shared
    local spec covers one slab + halo + the one-cell clamp pad, with cell
    capacity measured exactly per slab (each slab's owned + halo points
    binned in its own frame) times the slack. ``boost`` is the re-route
    hysteresis multiplier applied to every headroom knob.
    """
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    r = float(params.radius)
    margin = shopts.domain_margin_radii * r * boost
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    lo_x = float(lo[0])
    width = max((float(hi[0]) - lo_x) / n_slabs, 1e-6)
    halo = r

    ex = width + 2.0 * halo
    ey = max(float(hi[1] - lo[1]), r)
    ez = max(float(hi[2] - lo[2]), r)
    if cell_size is not None:
        cell = float(cell_size)
    else:
        # cells finer than the radius so megacells exist, bounded by the
        # dense-array budget per axis (choose_grid_spec's policy)
        cell = float(max(r / 4.0, max(ex, ey, ez) / shopts.max_dim))
    dims = tuple(min(int(math.ceil(e / cell)) + 3, shopts.max_dim + 3)
                 for e in (ex, ey, ez))
    origin0 = (lo_x - halo - cell, float(lo[1]) - cell, float(lo[2]) - cell)

    slab = _host_slabs(pts[:, 0], lo_x, width, n_slabs)
    p_cnt = np.bincount(slab, minlength=n_slabs)
    relx = pts[:, 0] - (lo_x + slab * width)
    # domain-edge outer faces ship nothing (no neighbor): size the caps
    # from the interior faces only
    nb_l = np.bincount(slab[(relx <= halo) & (slab > 0)],
                       minlength=n_slabs)
    nb_r = np.bincount(slab[(width - relx <= halo)
                            & (slab < n_slabs - 1)], minlength=n_slabs)

    point_cap = int(min(n, max(8, math.ceil(
        p_cnt.max() * shopts.point_slack * boost))))
    halo_cap = int(min(n, max(1, math.ceil(
        max(nb_l.max(), nb_r.max(), 1) * shopts.halo_slack * boost))))
    migrate_cap = int(min(max(1, point_cap // 2),
                          max(8, math.ceil(point_cap
                                           * shopts.migrate_frac))))

    # exact worst-case cell occupancy across the per-slab frames (the
    # frames are shifted by slab_width, which is not a cell multiple, so a
    # global-grid estimate would not bound them)
    occ_max = 1
    dims_a = np.asarray(dims)
    for s in range(n_slabs):
        xlo = lo_x + s * width - halo
        xhi = lo_x + (s + 1) * width + halo
        sel = pts[(pts[:, 0] >= xlo) & (pts[:, 0] <= xhi)]
        if not len(sel):
            continue
        o_s = np.asarray([xlo - cell, origin0[1], origin0[2]], np.float32)
        cc = np.clip(np.floor((sel - o_s) / cell).astype(np.int64), 0,
                     dims_a - 1)
        flat = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
        _u, occ = np.unique(flat, return_counts=True)
        occ_max = max(occ_max, int(occ.max()))
    capacity = int(max(1, math.ceil(
        occ_max * shopts.capacity_slack * boost)))

    if queries is not None:
        qs = np.asarray(queries, np.float32)
        q_cnt = np.bincount(_host_slabs(qs[:, 0], lo_x, width, n_slabs),
                            minlength=n_slabs)
        query_cap = int(max(1, math.ceil(
            q_cnt.max() / n_qsplit * shopts.query_slack * boost)))
    else:
        query_cap = int(max(1, math.ceil(point_cap / n_qsplit)))

    return SlabLayout(
        n_slabs=int(n_slabs), n_qsplit=int(n_qsplit), lo_x=lo_x,
        slab_width=float(width), halo=float(halo), point_cap=point_cap,
        halo_cap=halo_cap, migrate_cap=migrate_cap, query_cap=query_cap,
        spec=GridSpec(origin=origin0, cell_size=cell, dims=dims,
                      capacity=capacity))


def _host_slabs(x: np.ndarray, lo_x: float, width: float,
                n_slabs: int) -> np.ndarray:
    """Slab ids of float32 x-coordinates on the host: the same float32
    subtraction and division as :meth:`SlabLayout.slab_of`."""
    return np.clip(((x - np.float32(lo_x)) / np.float32(width))
                   .astype(np.int64), 0, n_slabs - 1)


def _check_routable(layout: SlabLayout, pts_np: np.ndarray) -> None:
    """Raise if :func:`route_points` would drop rows of ``pts_np``: a
    slab holds more points than ``point_cap``. Counted on the host with the
    device's arithmetic, so routing needs no fetch of its overflow count
    (it cannot be nonzero for a layout planned over these points unless
    ``point_slack * boost < 1``)."""
    slab = _host_slabs(pts_np[:, 0], layout.lo_x, layout.slab_width,
                       layout.n_slabs)
    if np.bincount(slab, minlength=layout.n_slabs).max() > layout.point_cap:
        raise RuntimeError("slab routing overflowed its own layout")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _rank_within(key: Tensor) -> Tensor:
    """Stable rank (int32) of each element among equal keys, in input
    order."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    ks = key[order].contiguous()
    first = torch.searchsorted(ks, ks, side="left")
    rank = torch.empty((n,), dtype=torch.int32, device=key.device)
    rank[order] = (torch.arange(n, device=key.device) - first).to(
        torch.int32)
    return rank


def _scatter_rows(slot: Tensor, values: Tensor, n_slots: int,
                  fill) -> Tensor:
    """``values`` written to rows ``slot`` of a ``fill``-ed [n_slots, ...]
    buffer; a slot equal to ``n_slots`` lands in the dump row, which is
    sliced off (the reference's ``.at[slot].set(..., mode="drop")``)."""
    out = values.new_full((n_slots + 1, *values.shape[1:]), fill)
    out[slot.long()] = values
    return out[:n_slots]


def route_points(layout: SlabLayout, points: Tensor,
                 ids: Tensor | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Slab routing of ``points`` [N, 3] into fixed-capacity per-slab
    buffers, on the points' device with no host synchronisation.

    Returns ``(pts [S, P, 3], ids [S, P], overflow)``: parked rows carry
    the sentinel position and id -1; ``overflow`` (0-d int32) counts
    points dropped because their slab's ``point_cap`` was exceeded.
    """
    n = points.shape[0]
    s_slabs, cap = layout.n_slabs, layout.point_cap
    dev = points.device
    gids = (torch.arange(n, dtype=torch.int32, device=dev) if ids is None
            else ids.to(torch.int32))
    slab = layout.slab_of(points[:, 0])
    rank = _rank_within(slab)
    keep = rank < cap
    slot = torch.where(keep, slab * cap + rank, s_slabs * cap)
    pts = _scatter_rows(slot, points.to(torch.float32), s_slabs * cap,
                        PARK_SENTINEL).reshape(s_slabs, cap, 3)
    out_ids = _scatter_rows(slot, gids, s_slabs * cap, -1).reshape(
        s_slabs, cap)
    return pts, out_ids, torch.logical_not(keep).sum(dtype=torch.int32)


def route_queries(layout: SlabLayout, queries: Tensor
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Query routing into ``[S, C, Q, 3]`` buffers (C = ``n_qsplit``
    round-robin columns per slab, the "model"-axis query split). Returns
    ``(qs, qid [S, C, Q], overflow)``."""
    nq = queries.shape[0]
    s_slabs, c, cap = layout.n_slabs, layout.n_qsplit, layout.query_cap
    dev = queries.device
    slab = layout.slab_of(queries[:, 0])
    rank = _rank_within(slab)
    col = rank % c
    pos = rank // c
    keep = pos < cap
    n_slots = s_slabs * c * cap
    slot = torch.where(keep, (slab * c + col) * cap + pos, n_slots)
    qs = _scatter_rows(slot, queries.to(torch.float32), n_slots,
                       PARK_SENTINEL).reshape(s_slabs, c, cap, 3)
    qid = _scatter_rows(slot, torch.arange(nq, dtype=torch.int32,
                                           device=dev),
                        n_slots, -1).reshape(s_slabs, c, cap)
    return qs, qid, torch.logical_not(keep).sum(dtype=torch.int32)


def unroute_results(qid: Tensor, gidx: Tensor, d2: Tensor, cnt: Tensor,
                    nq: int) -> tuple[Tensor, Tensor, Tensor]:
    """Inverse of the routing scatter: per-slab results back into original
    query order (rows with qid -1, the padding, are dropped)."""
    k = gidx.shape[-1]
    flat_q = qid.reshape(-1)
    safe = torch.where(flat_q >= 0, flat_q, nq)
    oi = _scatter_rows(safe, gidx.reshape(-1, k), nq, -1)
    od = _scatter_rows(safe, d2.reshape(-1, k), nq, float("inf"))
    oc = _scatter_rows(safe, cnt.reshape(-1), nq, 0)
    return oi, od, oc


# ---------------------------------------------------------------------------
# halo exchange + migration, batched over the slab axis
# ---------------------------------------------------------------------------

def _select_rows(pts: Tensor, ids: Tensor, mask: Tensor, cap: int
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """First ``cap`` rows of each slab where ``mask`` (stable row order,
    static shape): ``pts`` [S, R, 3], ``ids`` / ``mask`` [S, R].

    Returns ``(p [S, cap, 3], i [S, cap], n_masked [S])``; ``n_masked`` is
    the true masked count, so the caller can flag ``n_masked > cap``.
    """
    order = torch.argsort(torch.logical_not(mask).to(torch.int8), dim=-1,
                          stable=True)[:, :cap]
    valid = torch.gather(mask, 1, order)
    sel_p = torch.where(valid[..., None], torch.gather(
        pts, 1, order[..., None].expand(-1, -1, 3)), PARK_SENTINEL)
    sel_i = torch.where(valid, torch.gather(ids, 1, order), -1)
    return sel_p, sel_i, mask.sum(-1, dtype=torch.int32)


def _pack(p: Tensor, i: Tensor) -> Tensor:
    # ids shifted +1 so the zero fill at the mesh edge decodes to -1
    return torch.cat([p, (i + 1)[..., None].to(torch.float32)], dim=-1)


def _unpack(buf: Tensor) -> tuple[Tensor, Tensor]:
    i = buf[..., 3].to(torch.int32) - 1
    p = torch.where((i >= 0)[..., None], buf[..., :3], PARK_SENTINEL)
    return p, i


def _whole(n: int):
    """The block of a mesh axis of ``n`` items held all in process."""
    from ..launch.mesh import AxisBlock
    return AxisBlock(size=n, first=0, count=n)


def _own(x: Tensor, blk) -> Tensor:
    """The rank's block of ``x``'s leading axis (all of it in process)."""
    if blk.count == blk.size:
        return x
    return x[blk.first:blk.first + blk.count].clone()


def _shift(blk, to_right: Tensor, to_left: Tensor
           ) -> tuple[Tensor, Tensor]:
    """The reference's two ``ppermute``s along the slab axis: slab s
    receives ``to_right`` of slab s-1 and ``to_left`` of slab s+1 (leading
    axis: the block's slabs). Inside the block a shift; at its edges the
    neighbouring ranks' edge slabs, sent and received in one
    ``batch_isend_irecv`` (every rank issues its ops in the same order:
    left face, then right); zeros at the mesh edge."""
    edge_l = torch.zeros_like(to_right[:1])
    edge_r = torch.zeros_like(to_left[:1])
    if blk.group is not None:
        import torch.distributed as dist
        ops = []
        if blk.left is not None:
            ops += [dist.P2POp(dist.isend, to_left[0].contiguous(),
                               blk.left, blk.group),
                    dist.P2POp(dist.irecv, edge_l[0], blk.left, blk.group)]
        if blk.right is not None:
            ops += [dist.P2POp(dist.isend, to_right[-1].contiguous(),
                               blk.right, blk.group),
                    dist.P2POp(dist.irecv, edge_r[0], blk.right, blk.group)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return (torch.cat([edge_l, to_right[:-1]]),
            torch.cat([to_left[1:], edge_r]))


def _gather(x: Tensor, blk, dim: int = 0) -> Tensor:
    """``x``, whose axis ``dim`` holds the rank's ``blk.count`` items,
    gathered over the axis's ranks into all ``blk.size`` items (ranks in
    mesh order: ``launch/mesh.py`` checks it); ``x`` itself in process."""
    if blk.group is None:
        return x
    import torch.distributed as dist
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((blk.n_ranks * x.shape[0], *x.shape[1:]))
    gather(out, x, group=blk.group)
    return out.movedim(0, dim)


def _sum_over(x: Tensor, blk) -> Tensor:
    """The sum of ``x`` [n] over the axis's ranks, on the device."""
    if blk.group is not None:
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=blk.group)
    return x


def _reduce_header(head: Tensor, blk) -> Tensor:
    """A telemetry header reduced over the slab axis's ranks, on the
    device: flags and the staleness statistic by max, the counters by
    sum. The staleness is a non-negative float32 whose bit pattern, read
    as int32, orders as the float does."""
    if blk.group is None:
        return head
    heads = _gather(head[None], blk)
    out = heads.sum(0, dtype=torch.int32)
    for slot in (TELEM_FLAGS, TELEM_DISP_BITS):
        out[slot] = heads[:, slot].max()
    return out


def _gather_results(parts: tuple, blocks: list) -> tuple:
    """Per-row results of the rank's block (int32 or float32, each with a
    trailing k like the first or without one) gathered over the ranks of
    each ``(AxisBlock, dim)`` of ``blocks``: packed into int32 columns
    (float32 by its bit pattern), so one gather an axis moves them all,
    then unpacked. ``parts`` themselves in process."""
    ranked = [(blk, dim) for blk, dim in blocks if blk.group is not None]
    if not ranked:
        return parts
    lead = parts[0].dim()
    cols = [(p if p.dtype == torch.int32 else p.view(torch.int32))
            for p in parts]
    cols = [c if c.dim() == lead else c[..., None] for c in cols]
    packed = torch.cat(cols, dim=-1)
    for blk, dim in ranked:
        packed = _gather(packed, blk, dim)
    pieces = torch.split(packed, [c.shape[-1] for c in cols], dim=-1)
    return tuple((piece if p.dim() == lead else piece[..., 0]).view(p.dtype)
                 for p, piece in zip(parts, pieces))


def _slab_ids(layout: SlabLayout, device, blk=None) -> Tensor:
    """Global ids of the block's slabs (all of them in process)."""
    blk = blk or _whole(layout.n_slabs)
    return torch.arange(blk.first, blk.first + blk.count,
                        dtype=torch.int32, device=device)


def _with_halo(layout: SlabLayout, pts: Tensor, ids: Tensor, blk=None
               ) -> tuple[Tensor, Tensor, Tensor]:
    """O(surface) halo exchange: each slab ships the rows within ``halo``
    of its two faces to the neighbors. Returns the halo-extended
    ``(all_p [S, P + 2H, 3], all_i [S, P + 2H], overflow [S])`` of the
    block ``blk`` (all slabs when None)."""
    blk = blk or _whole(layout.n_slabs)
    sidx = _slab_ids(layout, pts.device, blk)
    slab_lo, slab_hi = layout.slab_bounds(sidx)
    halo = _f32(layout.halo, pts.device)
    valid = ids >= 0
    # domain-edge faces have no neighbor: nothing to ship, and points
    # piling against the domain boundary must not trip the halo cap
    has_left = (sidx > 0)[:, None]
    has_right = (sidx < layout.n_slabs - 1)[:, None]
    x = pts[..., 0]
    near_l = valid & (x - slab_lo[:, None] <= halo) & has_left
    near_r = valid & (slab_hi[:, None] - x <= halo) & has_right
    send_l_p, send_l_i, n_l = _select_rows(pts, ids, near_l,
                                           layout.halo_cap)
    send_r_p, send_r_i, n_r = _select_rows(pts, ids, near_r,
                                           layout.halo_cap)
    ovf = ((n_l - layout.halo_cap).clamp_min(0)
           + (n_r - layout.halo_cap).clamp_min(0))
    from_l, from_r = _shift(blk, _pack(send_r_p, send_r_i),
                            _pack(send_l_p, send_l_i))
    halo_l_p, halo_l_i = _unpack(from_l)
    halo_r_p, halo_r_i = _unpack(from_r)
    all_p = torch.cat([pts, halo_l_p, halo_r_p], dim=1)
    all_i = torch.cat([ids, halo_l_i, halo_r_i], dim=1)
    return all_p, all_i, ovf


def _migrate(layout: SlabLayout, pts: Tensor, ids: Tensor, blk=None
             ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cross-boundary particle migration (static per-face caps).

    Rows whose position left the slab travel to the adjacent slab and
    merge into free rows there. Returns ``(pts', ids', n_migrated [S],
    overflow [S])``: overflow is nonzero when a face cap overflowed, an
    arrival found no free row, or a row tried to hop more than one slab
    in a single step; all three trigger the host re-route. ``blk`` as in
    :func:`_with_halo`.
    """
    m_cap = layout.migrate_cap
    blk = blk or _whole(layout.n_slabs)
    sidx = _slab_ids(layout, pts.device, blk)
    valid = ids >= 0
    tgt = layout.slab_of(pts[..., 0])
    delta = torch.where(valid, tgt - sidx[:, None], 0)
    go_l = delta < 0
    go_r = delta > 0
    far = (delta.abs() > 1).sum(-1, dtype=torch.int32)

    send_l_p, send_l_i, n_l = _select_rows(pts, ids, go_l, m_cap)
    send_r_p, send_r_i, n_r = _select_rows(pts, ids, go_r, m_cap)
    ovf = (n_l - m_cap).clamp_min(0) + (n_r - m_cap).clamp_min(0) + far

    # vacate every mover's row (under overflow some movers are dropped:
    # the flag forces a full host re-route, so the state is discarded)
    gone = go_l | go_r
    pts1 = torch.where(gone[..., None], PARK_SENTINEL, pts)
    ids1 = torch.where(gone, -1, ids)

    from_l, from_r = _shift(blk, _pack(send_r_p, send_r_i),
                            _pack(send_l_p, send_l_i))
    in_p_l, in_i_l = _unpack(from_l)
    in_p_r, in_i_r = _unpack(from_r)
    in_p = torch.cat([in_p_l, in_p_r], dim=1)                # [S, 2M, 3]
    in_i = torch.cat([in_i_l, in_i_r], dim=1)
    arriving = in_i >= 0

    # merge arrivals into the first free rows (stable order): the k-th
    # ARRIVAL (not the k-th buffer slot: right-neighbor arrivals sit in
    # the second half of the buffer) takes the k-th free row
    free = ids1 < 0
    n_free = free.sum(-1, dtype=torch.int32)
    free_rows = torch.argsort(torch.logical_not(free).to(torch.int8),
                              dim=-1, stable=True)
    rank = torch.cumsum(arriving.to(torch.int32), dim=-1,
                        dtype=torch.int32) - 1                # [S, 2M]
    ok = arriving & (rank < n_free[:, None])
    n_rows = ids1.shape[1]
    dest = torch.where(ok, torch.gather(free_rows, 1,
                                        rank.clamp(0, n_rows - 1).long()),
                       n_rows)
    ovf = (ovf + arriving.sum(-1, dtype=torch.int32)
           - ok.sum(-1, dtype=torch.int32))
    # accepted arrivals target distinct free rows; the rest land in their
    # slab's dump row (row n_rows), which is sliced off; rows are counted
    # by the slab's place in the block, not its global id
    local = torch.arange(blk.count, device=pts.device)
    flat = (dest + local[:, None] * (n_rows + 1)).reshape(-1).long()
    pts2 = torch.cat([pts1, pts1[:, :1]], dim=1).reshape(-1, 3)
    ids2 = torch.cat([ids1, ids1[:, :1]], dim=1).reshape(-1)
    pts2[flat] = in_p.reshape(-1, 3)
    ids2[flat] = in_i.reshape(-1)
    pts2 = pts2.reshape(-1, n_rows + 1, 3)[:, :n_rows]
    ids2 = ids2.reshape(-1, n_rows + 1)[:, :n_rows]
    return pts2, ids2, n_l + n_r, ovf


# ---------------------------------------------------------------------------
# sharded one-shot query (ShardedIndex / shard_scene)
# ---------------------------------------------------------------------------

def _global_ids(res: SearchResult, all_i: Tensor):
    """A slab's local result rows as global ids, with d2 and counts of the
    rows that map to a real point."""
    gidx = torch.where(res.indices >= 0,
                       all_i[res.indices.clamp_min(0).long()], -1)
    d2 = torch.where(gidx >= 0, res.distances2, float("inf"))
    return gidx, d2, (gidx >= 0).sum(-1, dtype=torch.int32)


def _slab_indexes(layout: SlabLayout, params: SearchParams,
                  opts: SearchOpts, all_p: Tensor, blk=None) -> list:
    """Each slab's ``NeighborIndex`` over its halo-extended rows, on the
    shared spec in the slab's own frame (the slabs of ``blk``, all when
    None)."""
    origins = layout.origin_of(_slab_ids(layout, all_p.device, blk))
    return [api.build_index(all_p[s], params, opts, spec=layout.spec,
                            origin=origins[s], device=all_p.device)
            for s in range(all_p.shape[0])]


def make_sharded_query(layout: SlabLayout, params: SearchParams,
                       opts: SearchOpts, slabs=None, cols=None):
    """The sharded query as a closure: ``(pts [S_r,P,3], ids [S_r,P],
    queries [Nq,3]) -> (oi, od, oc, qovf)``: query routing, per slab of
    the block ``slabs`` the halo exchange, ``build_index`` and one
    ``api.query`` per query column of the block ``cols`` (``AxisBlock``s;
    all slabs and columns when None), the results gathered over the
    ranks, then the inverse scatter, with no host synchronisation. The
    reference caches a compiled program per (mesh, layout, params, opts,
    axes); the layout holds the slab and column counts, and there is
    nothing to compile."""
    opts = dataclasses.replace(opts, mask_parked=True)
    slabs = slabs or _whole(layout.n_slabs)
    cols = cols or _whole(layout.n_qsplit)

    def run(pts, ids, queries):
        qs, qid, qovf = route_queries(layout, queries)
        all_p, all_i, _ovf = _with_halo(layout, pts, ids, slabs)
        outs = []
        for s, index in enumerate(_slab_indexes(layout, params, opts,
                                                all_p, slabs)):
            outs.append([_global_ids(api.query(index, qs[slabs.first + s, c]),
                                     all_i[s])
                         for c in range(cols.first, cols.first + cols.count)])
        gidx, d2, cnt = _gather_results(
            tuple(torch.stack([torch.stack([o[j] for o in row])
                               for row in outs]) for j in range(3)),
            [(cols, 1), (slabs, 0)])
        oi, od, oc = unroute_results(qid, gidx, d2, cnt, queries.shape[0])
        return oi, od, oc, qovf

    return run


@dataclasses.dataclass
class ShardedIndex:
    """A scene decomposed into slabs on ``mesh.device``: this rank's block
    of them under a rank layout (``pts`` / ``ids`` its rows), all of them
    without one.

    Built by :func:`shard_scene`; ``query(queries)`` routes, searches each
    (slab, query column) of the rank's block, gathers the blocks' results
    over the ranks and un-routes, and returns the whole result in query
    order with GLOBAL point indices on every rank.
    """

    layout: SlabLayout
    params: SearchParams
    opts: SearchOpts
    mesh: object
    slab_axis: str
    query_axis: str | None
    pts: Tensor             # [S_r, P, 3] owned rows (sentinel-parked pads)
    ids: Tensor             # [S_r, P] global ids (-1 pads)

    def query(self, queries) -> SearchResult:
        """Search ``queries`` [Nq, 3]. Its one blocking transfer is the
        query-overflow count, fetched after every launch has been
        queued."""
        queries = api._as_points(queries, self.pts.device)
        cols = (self.mesh.block(self.query_axis) if self.query_axis
                else None)
        fn = make_sharded_query(self.layout, self.params, self.opts,
                                self.mesh.block(self.slab_axis), cols)
        oi, od, oc, qovf = fn(self.pts, self.ids, queries)
        n_over = int(qovf.cpu())
        if n_over:
            raise RuntimeError(
                f"query routing overflowed the layout's query_cap="
                f"{self.layout.query_cap} ({n_over} dropped); re-plan "
                "with shard_scene(..., queries=...) sized for this batch")
        return SearchResult(indices=oi, distances2=od, counts=oc)


def _mesh_for(mesh, n_slabs, slab_axis, device):
    if mesh is None:
        from ..launch.mesh import make_slab_mesh
        mesh = make_slab_mesh(n_slabs, axis=slab_axis, device=device)
    return mesh


def shard_scene(points, params: SearchParams, *,
                mesh=None, n_slabs: int | None = None,
                opts: SearchOpts = SearchOpts(),
                shopts: ShardOpts = ShardOpts(),
                queries=None, cell_size: float | None = None,
                slab_axis: str = "data",
                query_axis: str | None = None,
                device="cuda") -> ShardedIndex:
    """Decompose a scene into slabs on ``mesh.device``.

    Host work is the layout planning only (:func:`plan_layout`); the
    routing itself is the padded scatter on the device, of the whole
    scene on every rank of a rank layout, each keeping its block.
    ``queries`` optionally sizes the query routing caps; ``mesh`` defaults
    to ``make_slab_mesh(n_slabs, device=device)``, which runs on the card
    unless ``device="cpu"`` (one slab per rank under a process group of
    more than one rank).
    """
    mesh = _mesh_for(mesh, n_slabs, slab_axis, device)
    n_slabs = int(mesh.shape[slab_axis])
    n_qsplit = int(mesh.shape[query_axis]) if query_axis else 1
    opts = dataclasses.replace(opts, mask_parked=True)
    pts_np = _host_points(points)
    qs_np = None if queries is None else _host_points(queries)
    layout = plan_layout(pts_np, params, n_slabs, n_qsplit=n_qsplit,
                         queries=qs_np, shopts=shopts, cell_size=cell_size)
    _check_routable(layout, pts_np)
    pts, ids, _ovf = route_points(layout, api._as_points(pts_np,
                                                         mesh.device))
    blk = mesh.block(slab_axis)
    return ShardedIndex(layout=layout, params=params, opts=opts, mesh=mesh,
                        slab_axis=slab_axis, query_axis=query_axis,
                        pts=_own(pts, blk), ids=_own(ids, blk))


# ---------------------------------------------------------------------------
# slab-resident session
# ---------------------------------------------------------------------------

class ShardedSession:
    """Slab-resident :class:`~.dynamic.SimulationSession`.

    >>> sess = ShardedSession(points, SearchParams(radius=0.1, k=8),
    ...                       n_slabs=4)
    >>> for _ in range(steps):
    ...     res = sess.step(points)          # global order, global ids
    ...     points = integrate(points, res)

    ``step(points)`` takes the frame's positions in global id order
    [N, 3]. Each slab gathers its rows' new positions by resident id,
    migrates rows across faces, takes its halo, re-bins its frozen local
    grid (``update_index``), then replans or replays its captured plan.
    Results equal a single-device session's on the same trajectory. The
    only host routing is construction and the exhausted-layout fallback
    (``stats()["host_routings"]``).

    One blocking transfer a step: the packed telemetry vector, the
    reference's header (flags reduced by max across slabs) then one stale
    flag per slab. The host decides each slab's replan or replay from it
    (the reference's per-slab ``lax.cond``), so ``step`` returns with the
    search in flight. An exhausted layout costs a second transfer (the
    points, for the re-route), after which every slab replays the plan
    captured on the fresh layout, as the reference's second pass does. The
    reference's ``compile`` span and jit cache have no counterpart.

    Under a rank layout (``launch/mesh.py``) each rank steps its block of
    slabs with the whole frame; halos and migrating rows go rank to rank,
    the telemetry header is reduced over the ranks before the fetch (so
    every rank takes the same branch), and results are gathered, so every
    rank returns the whole result. ``stats()`` is then a collective: every
    rank of the slab axis calls it, and each reports the whole session's
    counters.
    """

    def __init__(self, points, params: SearchParams,
                 opts: SearchOpts = SearchOpts(),
                 sopts: SessionOpts = SessionOpts(),
                 shopts: ShardOpts = ShardOpts(),
                 mesh=None, n_slabs: int | None = None,
                 slab_axis: str = "data", *, device="cuda"):
        validate_session_opts(sopts)
        mesh = _mesh_for(mesh, n_slabs, slab_axis, device)
        self._mesh = mesh
        self._dev = mesh.device
        self._n_slabs = int(mesh.shape[slab_axis])
        self._blk = mesh.block(slab_axis)
        self.params = params
        self.opts = dataclasses.replace(opts, mask_parked=True)
        self.sopts = sopts
        self.shopts = shopts
        self._boost = 1.0
        self._metrics = obs.metric_set("sharded_session")
        self.last_flags = 0
        self._t_last = 0.0
        self._migrated = 0
        # fresh plans' tile histograms (and a re-route's halo volume) on
        # their way to the host behind an event; counted once landed
        self._pending = []
        pts_np = _host_points(points)
        self._n = int(pts_np.shape[0])
        self._reroute(pts_np, api._as_points(pts_np, self._dev),
                      count=False)

    # -- surface ------------------------------------------------------------

    @property
    def layout(self) -> SlabLayout:
        return self._layout

    @property
    def spec(self) -> GridSpec:
        return self._layout.spec

    def stats(self) -> dict:
        self._fold(wait=True)
        counters = dict(steps=0, fast_steps=0, replans=0, reroutes=0,
                        host_routings=0, host_syncs=0)
        counters.update(self._metrics.counters())
        counters.update(self._occupancy_over_ranks(counters))
        return {
            **counters,
            "migrated": int(self._migrated),
            "last_flags": int(self.last_flags),
            "boost": float(self._boost),
            "t_step": float(self._t_last),   # wall time of the last step
        }

    def _occupancy_over_ranks(self, counters: dict) -> dict:
        """The ``level_occ_*`` counters summed over the slab axis's ranks
        (each rank counts its own slabs' plans); nothing in process."""
        if self._blk.group is None:
            return {}
        import torch.distributed as dist
        n = torch.tensor([sum(k.startswith("level_occ_") for k in counters)],
                         dtype=torch.int32, device=self._dev)
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=self._blk.group)
        keys = [f"level_occ_{lvl}" for lvl in range(int(n.item()))]
        vals = _sum_over(torch.tensor([counters.get(key, 0) for key in keys],
                                      dtype=torch.int64, device=self._dev),
                         self._blk)
        return dict(zip(keys, vals.tolist()))

    # -- telemetry ----------------------------------------------------------

    def _stage(self, slabs: list, count: bool, halo: Tensor | None = None):
        """Start the copy of the plans of ``slabs``' tile histograms (and a
        re-route's halo volume) to the host, into pinned memory behind an
        event, so it adds no sync. ``count`` False only learns them."""
        n_levels = len(self._plan[slabs[0]].ladder)
        vec = torch.cat([obs.level_occupancy(self._plan[s].tile_levels,
                                             n_levels) for s in slabs]
                        + ([] if halo is None else [halo.reshape(1)]))
        event = None
        if vec.device.type == "cuda":
            host = torch.empty(vec.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(vec.device))
            vec = host
        self._pending.append((event, vec, slabs, n_levels, count,
                              halo is not None))

    def _fold(self, wait: bool = False) -> None:
        """Count staged histograms whose copies have landed. After a
        step's fetch they all have (the fetch waited for the stream), so
        the event query is no sync; ``stats()`` waits."""
        while self._pending:
            event, host, slabs, n_levels, count, has_halo = self._pending[0]
            if event is not None and not event.query():
                if not wait:
                    return
                event.synchronize()
            self._pending.pop(0)
            vals = host.tolist()
            for j, s in enumerate(slabs):
                self._plan_occ[s] = vals[j * n_levels:(j + 1) * n_levels]
                if count:
                    self._count_occupancy(self._plan_occ[s])
            if count and has_halo:
                self._metrics.count("halo_rows", vals[-1])

    def _count_occupancy(self, occ) -> None:
        for lvl, n in enumerate(occ):
            self._metrics.count(f"level_occ_{lvl}", n)

    # -- lifecycle ----------------------------------------------------------

    def _reroute(self, pts_np: np.ndarray, pts: Tensor, count: bool):
        """Host fallback (and bootstrap): re-plan the layout from current
        positions, re-route every row, rebuild the per-slab indexes and
        recapture the per-slab plans. No transfer of its own: ``pts_np``
        and ``pts`` are the same positions on the host and the device.
        ``count`` stages the fresh plans' histograms and halo volume as
        this step's (the re-route's second pass replays those plans).
        Returns the halo-extended rows and ids of the rank's block."""
        self._metrics.count("host_routings")
        layout = plan_layout(pts_np, self.params, self._n_slabs,
                             shopts=self.shopts, boost=self._boost)
        _check_routable(layout, pts_np)
        self._layout = layout
        self._thr2 = _f32((self.sopts.displacement_frac
                           * layout.spec.cell_size) ** 2, self._dev)
        blk = self._blk
        p, ids, _ovf = route_points(layout, pts)
        p, ids = _own(p, blk), _own(ids, blk)
        all_p, all_i, _hovf = _with_halo(layout, p, ids, blk)
        self._pts, self._ids = p, ids
        self._index = _slab_indexes(layout, self.params, self.opts, all_p,
                                    blk)
        margin = int(self.sopts.reuse_margin_cells)
        self._plan = [api.plan_query(self._index[s], p[s], margin=margin)
                      for s in range(blk.count)]
        self._plan_occ = [None] * blk.count
        self._migrated = 0
        halo = _sum_over((all_i[:, layout.point_cap:] >= 0).sum(
            dtype=torch.int32).reshape(1), blk)
        self._stage(list(range(blk.count)), count, halo if count else None)
        return all_p, all_i

    def _update(self, pg: Tensor):
        """Every slab of the block advanced to the frame ``pg``: gather by
        resident id, migrate, halo exchange, ``update_index``; and the
        packed telemetry vector [header reduced over the ranks | stale
        flag per slab of the block], all on the device."""
        layout, blk = self._layout, self._blk
        valid = self._ids >= 0
        new = torch.where(valid[..., None],
                          pg[self._ids.clamp_min(0).long()], PARK_SENTINEL)
        pts2, ids2, n_mig, mig_ovf = _migrate(layout, new, self._ids, blk)
        all_p, all_i, halo_ovf = _with_halo(layout, pts2, ids2, blk)
        updated = [api.update_index(self._index[s], all_p[s])
                   for s in range(blk.count)]
        overflow = torch.stack([st.overflow for _i, st in updated]).to(
            torch.int32)
        oob = torch.stack([st.oob for _i, st in updated]).to(torch.int32)
        disp2 = torch.stack([st.max_disp2 for _i, st in updated])
        bad = (overflow > 0) | (oob > 0) | (mig_ovf > 0) | (halo_ovf > 0)
        stale = disp2 > self._thr2
        flags = (stale.to(torch.int32) * _FLAG_REPLANNED
                 + bad.to(torch.int32) * _FLAG_EXHAUSTED)
        halo_vol = (all_i[:, layout.point_cap:] >= 0).sum(dtype=torch.int32)
        head = _reduce_header(obs.pack_step_telemetry(
            flags.max(), overflow=overflow.sum(), oob=oob.sum(),
            max_disp2=disp2.max(), migrated=n_mig.sum(), halo=halo_vol),
            blk)
        telem = torch.cat([head, stale.to(torch.int32)])
        return pts2, ids2, all_p, all_i, [i for i, _st in updated], telem

    def step(self, points) -> SearchResult:
        """Advance every slab to the frame ``points`` [N, 3] (global id
        order) and self-query. One blocking transfer (two on a re-route);
        results come back in global order with global ids."""
        m = self._metrics
        with obs.span("step", slabs=self._n_slabs) as sp_step:
            pg = api._as_points(points, self._dev)
            with obs.span("plan"):
                if pg.shape != (self._n, 3):
                    # particle count changed: the layout's static caps are
                    # stale
                    self._n = int(pg.shape[0])
                    self._reroute(pg.cpu().numpy(), pg, count=False)
            with obs.span("launch"):
                pts2, ids2, all_p, all_i, index2, telem = self._update(pg)
            with obs.span("sync"):
                vec = telem.cpu().numpy()
            m.count("host_syncs")
            self._fold()
            tel = obs.unpack_step_telemetry(vec[:obs.TELEM_HEADER])
            stale = vec[obs.TELEM_HEADER:].tolist()
            fl = tel["flags"]

            if fl & _FLAG_EXHAUSTED:
                if not self.shopts.auto_reroute:
                    raise RuntimeError(
                        "sharded layout exhausted (migration/halo/capacity/"
                        "bounds) and auto_reroute is disabled")
                # respec-style fallback with hysteresis: geometrically more
                # headroom per re-route, so adversarial drift costs O(log
                # frames) re-routes
                m.count("reroutes")
                self._boost = min(self._boost * self.shopts.reroute_growth,
                                  self.shopts.reroute_boost_max)
                with obs.span("plan", reroute=True):
                    host = pg.cpu().numpy()
                    m.count("host_syncs")
                    all_p, all_i = self._reroute(host, pg, count=True)
                # the second pass on the fresh layout: nothing moves, every
                # displacement is 0, so every slab replays its new plan
                tel = dict(tel, flags=0, overflow=0, oob=0, max_disp2=0.0,
                           migrated=0, halo=0)
                fl = 0
                res = self._search(self._pts, self._ids, self._index,
                                   [False] * self._blk.count, all_p, all_i,
                                   count=False)
            else:
                res = self._search(pts2, ids2, index2, stale, all_p, all_i,
                                   count=True)
                self._pts, self._ids = pts2, ids2
                self._migrated += tel["migrated"]

            self.last_flags = fl
            m.count("steps")
            if fl & _FLAG_REPLANNED:
                m.count("replans")
            else:
                m.count("fast_steps")
            m.count("migrated_rows", tel["migrated"])
            m.count("halo_rows", tel["halo"])
            m.count("overflow_points", tel["overflow"])
            m.count("oob_points", tel["oob"])
            m.gauge("staleness_disp2", tel["max_disp2"])
            m.gauge("boost", self._boost)
        self._t_last = sp_step.duration
        m.observe("step_s", self._t_last)
        return res

    def _search(self, pts, ids, index, stale, all_p, all_i,
                count: bool) -> SearchResult:
        """Each slab of the block replans (``stale``) or replays its
        captured plan, then ``execute_plan`` over its owned rows; results
        (with the owned rows' ids) gathered over the ranks and un-routed to
        global order. ``count`` counts the replayed plans' histograms
        (False after a re-route, whose fresh plans are counted when their
        staged histograms land)."""
        with obs.span("launch", stage="search"):
            margin = int(self.sopts.reuse_margin_cells)
            replanned, outs = [], []
            for s in range(self._blk.count):
                if stale[s]:
                    self._plan[s] = api.plan_query(index[s], pts[s],
                                                   margin=margin)
                    index[s] = index[s].with_anchor(all_p[s])
                    replanned.append(s)
                elif count:
                    self._count_occupancy(self._plan_occ[s])
                outs.append(_global_ids(
                    api.execute_plan(index[s], pts[s], self._plan[s]),
                    all_i[s]))
            self._index = index
            if replanned:
                self._stage(replanned, count=True)
            gidx, d2, cnt, rows = _gather_results(
                tuple(torch.stack([o[j] for o in outs]) for j in range(3))
                + (ids,), [(self._blk, 0)])
            oi, od, oc = unroute_results(rows, gidx, d2, cnt, self._n)
        return SearchResult(indices=oi, distances2=od, counts=oc)


__all__ = [
    "STATIC_SCENE_OPTS",
    "ShardOpts",
    "ShardedIndex",
    "ShardedSession",
    "SlabLayout",
    "make_sharded_query",
    "plan_layout",
    "route_points",
    "route_queries",
    "shard_scene",
    "unroute_results",
]
