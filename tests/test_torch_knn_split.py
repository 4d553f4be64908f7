"""The split of ``knn_tile_anchored``'s windows into work items and the
order-free merge of their partial top-Ks, on grids built by the JAX
reference (``repro.core.grid.build_cell_grid``).

The kernel cuts each tile's window into items of at most ``SEG`` slots
(``knn_tile.work_items``), keeps the window position beside each entry of
an item's partial top-K, and merges the partial lists by the key
(d2, position) in whatever order the items finish. The plain model below
does the same in plain PyTorch, with the items merged in a shuffled
order, and must equal ``knn_tile_anchored_plain`` (one stream in window
order) bitwise. On the card the kernel itself is held against the plain
version with a small ``SEG``, so that every tile splits into many items.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grid import build_cell_grid, choose_grid_spec
from repro_torch.kernels import knn_tile as tknn

ENTRIES = ((3, 3, 3), (5, 4, 6), (7, 7, 7))


def _scene(rng, n=500, r=0.15, dup=False):
    pts = rng.random((n, 3)).astype(np.float32)
    if dup:   # every point of the first 150 twice, at another id: ties
        pts = np.concatenate([pts, pts[:150]])
    spec = choose_grid_spec(pts, r)
    grid = build_cell_grid(jnp.asarray(pts), spec)
    return pts, spec, np.array(grid.dense).reshape(-1)


def _tiles(rng, spec, tile, levels, dup_queries=None):
    n_tiles = len(levels)
    qs = rng.random((n_tiles * tile, 3)).astype(np.float32)
    if dup_queries is not None:   # queries on the points: zero distances
        qs[::3] = dup_queries[rng.integers(0, len(dup_queries),
                                           qs[::3].shape[0])]
    anchors = np.zeros((n_tiles, 3), np.int32)
    for i, lvl in enumerate(levels):
        ws = ENTRIES[lvl] if 0 <= lvl < len(ENTRIES) else (1, 1, 1)
        anchors[i] = rng.integers(0, np.asarray(spec.dims) - ws + 1)
    return qs, anchors, np.asarray(levels, np.int32)


def _table(skip):
    return torch.tensor([(*ws, int(skip)) for ws in ENTRIES],
                        dtype=torch.int32)


def _extents(rng, spec, anchors, levels, table, boxed):
    """Each tile's window extent: its level's table entry, or with
    ``boxed`` a box of its own, 1 to 8 cells a side from its anchor and
    inside the grid (as a full-radius tile's exact box is)."""
    ext = tknn.table_extents(torch.as_tensor(levels),
                             torch.as_tensor(table))
    if boxed:
        room = np.asarray(spec.dims) - np.asarray(anchors)
        box = np.minimum(rng.integers(1, 9, (len(levels), 3)), room)
        ext = torch.where(ext > 0, torch.from_numpy(box.astype(np.int32)),
                          ext)
    return ext


def _decode(order, cum, cells, cap, seg):
    """Item i -> (tile, first slot, last slot), as the kernel decodes it:
    j is the largest index with cum[j] <= i, the tile is order[j], and the
    item is the cells [s * seg_cells, (s + 1) * seg_cells) of that tile's
    window, s = i - cum[j], clipped to its cells."""
    seg_cells = max(1, seg // cap)
    i = torch.arange(int(cum[-1]))
    j = torch.searchsorted(cum, i.to(torch.int32), right=True) - 1
    tile = order[j].long()
    first = (i - cum[j]) * seg_cells
    last = torch.minimum(first + seg_cells, cells[tile])
    return torch.stack([tile, first * cap, last * cap], 1)


def _window_cells(levels, table, extents):
    out = []
    for lvl, (wx, wy, wz) in zip(levels.tolist(), extents.tolist()):
        out.append(wx * wy * wz if 0 <= lvl < table.shape[0] else 0)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("seg", [1, 50, 700, tknn.SEG])
@pytest.mark.parametrize("levels", [
    [0, 1, 2, -1, 1, 3, 2, 0],
    [2, 2, 2],
    [-1, -1],
    [1],
])
def test_work_items_cover_every_window_largest_first(rng, levels, seg,
                                                      boxed):
    """Every slot of every on-level window (its tile's extent: the level's
    table entry, or a box of its own) lies in exactly one item, in window
    order, each item whole cells and at most ``seg`` slots (or one cell
    where a cell holds more); an off-level tile has one empty item; items
    come by descending window size; the count stays within the host-static
    bound ``n_tiles * max(1, ceil(max window cells / seg_cells))``."""
    cap = 4
    table = torch.tensor([(3, 2, 1, 0), (4, 4, 4, 1), (1, 5, 3, 0)],
                         dtype=torch.int32)
    lv = torch.tensor(levels, dtype=torch.int32)
    ext = tknn.table_extents(lv, table)
    if boxed:
        box = torch.from_numpy(rng.integers(1, 9, (len(levels), 3)))
        ext = torch.where(ext > 0, box.to(torch.int32), ext)
    order, cum = tknn.work_items(lv, table, ext, cap, seg)
    assert order.dtype == torch.int32 and cum.dtype == torch.int32
    assert cum.shape == (len(levels) + 1,) and int(cum[0]) == 0
    cells = _window_cells(lv, table, ext)
    seg_cells = max(1, seg // cap)
    n_items = int(cum[-1])
    bound = len(levels) * max(1, -(-int(cells.max()) // seg_cells))
    assert len(levels) <= n_items <= bound
    assert sorted(order.tolist()) == list(range(len(levels)))
    assert (cells[order.long()][:-1] >= cells[order.long()][1:]).all()

    items = _decode(order, cum, cells, cap, seg)
    for t in range(len(levels)):
        mine = items[items[:, 0] == t]
        m = int(cells[t]) * cap
        if m == 0:
            assert mine.tolist() == [[t, 0, 0]]
            continue
        assert len(mine) == -(-int(cells[t]) // seg_cells)
        assert int(mine[0, 1]) == 0 and int(mine[-1, 2]) == m
        assert (mine[1:, 1] == mine[:-1, 2]).all()        # contiguous
        assert ((mine[:, 1] % cap) == 0).all()             # whole cells
        assert ((mine[:, 2] - mine[:, 1]) <= max(seg, cap)).all()
        assert ((mine[:, 2] - mine[:, 1]) > 0).all()


def test_work_items_empty_table():
    lv = torch.tensor([0, -1, 3], dtype=torch.int32)
    table = torch.zeros((0, 4), dtype=torch.int32)
    order, cum = tknn.work_items(lv, table, tknn.table_extents(lv, table),
                                 cap=8)
    assert cum.tolist() == [0, 1, 2, 3] and order.tolist() == [0, 1, 2]


@pytest.mark.parametrize("n_tiles", [1, 7, 3907])
def test_launch_scratch_size(rng, n_tiles):
    """The kernel's scratch is 16 * n_tiles + 8 bytes and one byte a grid
    cell, whatever k and the window sizes: it does not grow with items x
    tile x k. The occupancy bytes say which cells hold any id, whatever
    slots the ids sit in."""
    cap, n_cells = 5, 60
    dense = torch.full((n_cells * cap,), -1, dtype=torch.int32)
    filled = rng.choice(n_cells * cap, 40, replace=False)
    dense[torch.from_numpy(filled)] = torch.arange(40, dtype=torch.int32)
    lv = torch.zeros((n_tiles,), dtype=torch.int32)
    for ws in ((1, 1, 1), (3, 4, 5)):
        table = torch.tensor([(*ws, 0)], dtype=torch.int32)
        scratch = tknn.launch_scratch(lv, table,
                                      tknn.table_extents(lv, table), dense,
                                      cap)
        assert sum(t.numel() * t.element_size() for t in scratch) == \
            16 * n_tiles + 8 + n_cells
        occupied, sync = scratch[2], scratch[3]
        assert occupied.tolist() == [c in set(filled // cap)
                                     for c in range(n_cells)]
        assert not sync.any()


def _split_merge_model(q, points, dense, anchors, levels, table, extents,
                       *, dims, cap, k, r2, tile, seg, rng):
    """Partial top-Ks over each tile's items, each entry keyed by (d2,
    window position), merged in a shuffled order, then the positions turned
    back into ids."""
    n_tiles = anchors.shape[0]
    n_flat = dense.shape[0]
    _, dy, dz = dims
    order, cum = tknn.work_items(levels, table, extents, cap, seg)
    items = _decode(order, cum, _window_cells(levels, table, extents), cap,
                    seg)
    items = items[torch.from_numpy(rng.permutation(len(items)))]

    def ids_at(t, pos):
        wx, wy, wz = extents[t].tolist()
        ax, ay, az = anchors[t].tolist()
        slot, cell = pos % cap, pos // cap
        iz, iy, ix = cell % wz, (cell // wz) % wy, cell // (wz * wy)
        flat = (((ax + ix) * dy + (ay + iy)) * dz + (az + iz)) * cap + slot
        return dense[flat.clamp(0, n_flat - 1)]

    held = {}
    for t, first, last in items.tolist():
        qt = q[t * tile:(t + 1) * tile]
        empty = (torch.full((tile, k), float("inf")),
                 torch.full((tile, k), -1, dtype=torch.int64))
        if last > first:
            pos = torch.arange(first, last)
            ids = ids_at(t, pos)
            # the plain stream over this item, its points indexed by the
            # item's local slot: it returns local positions for ids
            local = torch.where(ids >= 0, pos - first, -1)
            pts_local = points[ids.clamp(0, points.shape[0] - 1).long()]
            d2, lp = tknn._stream_plain(qt, pts_local, [local], k=k, r2=r2,
                                        skip=bool(table[int(levels[t]), 3]))
            part = (d2, torch.where(lp >= 0, lp.long() + first, -1))
        else:
            part = empty
        if t in held:   # merge by (d2, position): the kernel's key
            d2 = torch.cat([held[t][0], part[0]], 1)
            pos = torch.cat([held[t][1], part[1]], 1)
            by_pos = torch.argsort(pos, dim=1, stable=True)
            d2, pos = d2.gather(1, by_pos), pos.gather(1, by_pos)
            by_d2 = torch.argsort(d2, dim=1, stable=True)[:, :k]
            part = (d2.gather(1, by_d2), pos.gather(1, by_d2))
        held[t] = part

    out_d2 = torch.empty((n_tiles * tile, k))
    out_idx = torch.empty((n_tiles * tile, k), dtype=torch.int32)
    for t, (d2, pos) in held.items():
        lvl_on = 0 <= int(levels[t]) < table.shape[0]
        ids = (ids_at(t, pos.clamp_min(0)) if lvl_on
               else torch.zeros_like(pos, dtype=torch.int32))
        out_d2[t * tile:(t + 1) * tile] = d2
        out_idx[t * tile:(t + 1) * tile] = torch.where(
            torch.isinf(d2), -1, ids).to(torch.int32)
    return out_d2, out_idx


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_split_merge_model_equals_one_stream(rng, k, skip, dup, boxed):
    """Windows of 27, 120 and 343 cells (or, ``boxed``, a box of up to 512
    cells a tile) cut into items of 37 slots (a few whole cells each),
    merged in a shuffled order: bitwise the one-stream plain version, ties
    from duplicated points and queries on them included. k = 100 exceeds
    the valid candidates of the smallest window; two tiles are off the
    table (-1 and one past it)."""
    tile, r = 16, 0.15
    pts, spec, dense = _scene(rng, dup=dup)
    levels = [0, 1, 2, -1, 2, 3, 0]
    qs, anchors, levels = _tiles(rng, spec, tile, levels,
                                 dup_queries=pts if dup else None)
    t = torch.from_numpy
    table = _table(skip)
    args = (t(qs), t(pts), t(dense), t(anchors), t(levels), table,
            _extents(rng, spec, anchors, levels, table, boxed))
    kw = dict(dims=spec.dims, cap=spec.capacity, k=k, r2=r * r, tile=tile)
    want_d2, want_idx = tknn.knn_tile_anchored_plain(*args, **kw)
    got_d2, got_idx = _split_merge_model(*args, **kw, seg=37, rng=rng)
    assert torch.equal(got_d2, want_d2) and torch.equal(got_idx, want_idx)
    if k == 100 and not boxed:   # some row holds fewer than k: padding
        assert torch.isinf(want_d2[:tile]).any()
    if dup and k > 1 and not boxed:   # a row holds a tie on d2
        tie = want_d2[:, 1:] == want_d2[:, :-1]
        assert (tie & torch.isfinite(want_d2[:, 1:])).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 128, 1024])
@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_kernel_split_matches_plain_on_card(rng, monkeypatch, k, tile):
    """The CUDA kernel with items of one cell (every window split, up to
    343 items a tile, merged in whatever order the CTAs finish) equals the
    plain version bitwise, ties, both skip flags and off-level tiles
    included; as does the kernel with its own SEG."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    pts, spec, dense = _scene(rng, n=3000, r=0.1, dup=True)
    qs, anchors, levels = _tiles(rng, spec, tile, [2, 0, 1, -1, 2, 3, 1],
                                 dup_queries=pts)
    for skip in (False, True):
        args = [torch.from_numpy(a).cuda() for a in
                (qs, pts, dense, anchors, levels)] + [_table(skip).cuda()]
        args.append(tknn.table_extents(args[4], args[5]))
        kw = dict(dims=spec.dims, cap=spec.capacity, k=k, r2=0.1 ** 2,
                  tile=tile)
        want = tknn.knn_tile_anchored_plain(*args, **kw)
        for seg in (1, tknn.SEG):
            monkeypatch.setattr(tknn, "SEG", seg)
            got = tknn.knn_tile_anchored(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (seg, skip)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 40, 2048])
@pytest.mark.parametrize("k", [129, 300])
def test_kernel_any_k_and_tile_matches_plain_on_card(rng, monkeypatch, k,
                                                     tile):
    """A top-k longer than one launch keeps (passes of 128 columns, each
    after the last key of the one before) on tiles that are not a whole
    number of warps (8, 40) or exceed a CTA's 1024 rows (2048: two row
    blocks sharing the tile's window): bitwise the plain version, with
    items of one cell and with the kernel's own SEG, both skip flags,
    off-level tiles, duplicated points (ties) and queries on them. With
    the sphere test on, every row holds fewer valid candidates than k; the
    27-cell window holds fewer than k even without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    pts, spec, dense = _scene(rng, n=3000, r=0.1, dup=True)
    qs, anchors, levels = _tiles(rng, spec, tile, [2, 0, 1, -1, 2],
                                 dup_queries=pts)
    for skip in (False, True):
        args = [torch.from_numpy(a).cuda() for a in
                (qs, pts, dense, anchors, levels)] + [_table(skip).cuda()]
        args.append(tknn.table_extents(args[4], args[5]))
        kw = dict(dims=spec.dims, cap=spec.capacity, k=k, r2=0.1 ** 2,
                  tile=tile)
        want = tknn.knn_tile_anchored_plain(*args, **kw)
        assert torch.isinf(want[0][tile:2 * tile, -1]).all()
        for seg in (1, tknn.SEG):
            monkeypatch.setattr(tknn, "SEG", seg)
            before = tknn.knn_tile_anchored.launches
            got = tknn.knn_tile_anchored(*args, **kw)
            torch.cuda.synchronize()
            assert tknn.knn_tile_anchored.launches == \
                before + -(-k // tknn.MAX_K)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (seg, skip)
