"""The walk counter of ``knn_tile_anchored``'s kernel, on the card: what
it counts (query rows, boxed rows, window cells, occupied cells, candidate
ids, candidate pairs), in all and by launch signature, equals as integers
what the launch's windows (each tile's anchor and extent) hold by the
grid's summed-area tables (the pairs are ``chip_smoke.knn_work``'s: valid
candidates times the tile; a tile of several row blocks walks its window
once a block); launches add up; the outputs stay the plain version's
bitwise; and neither the launch inputs, the launch nor its counting
synchronise with the host before ``kernel_counters`` is called. A
full-radius tile's exact box gives bitwise the rows of its ladder cube."""
import numpy as np
import pytest
import torch

from repro_torch import api, obs
from repro_torch.core.grid import _summed_area_table, box_count
from repro_torch.kernels import knn_tile, ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    obs.reset()
    yield
    obs.reset()


def _plan(pts, params, tile):
    """A self-query's index, plan and scheduled queries on the card."""
    index = api.build_index(pts, params,
                            api.SearchOpts(use_pallas=True, query_tile=tile),
                            device="cuda")
    plan = api.plan_query(index, index.points)
    return index, plan, index.points[plan.perm.long()]


def _inputs(index, plan, qs):
    """The one ``knn_tile_anchored`` launch of ``api.execute_plan``."""
    params = index.params
    return ops.launch_inputs(index.grid, index.points, qs, index.spec,
                             plan.ladder, plan.tile_levels, params.radius,
                             params.k, plan.tile, index.origin)


def _ladder_args(index, plan, args):
    """The same launch with every tile on its ladder cube: the anchors of
    ``assign_tile_levels`` and its entries' extents."""
    dims = tuple(index.spec.dims)
    qc = index.spec.cell_of(args[0], index.origin).reshape(-1, plan.tile, 3)
    entries = ops.segment_levels(plan.ladder, dims)
    plevel, anchors = ops.assign_tile_levels(qc, plan.tile_levels,
                                             plan.ladder, entries, dims)
    return args[:3] + [anchors, plevel, args[5],
                       knn_tile.table_extents(plevel, args[5])]


def _windows(index, args, kw):
    """Per tile: window cells, occupied cells and valid candidates."""
    spec, anchors, ws = index.spec, args[3], args[6]
    hi = anchors + ws - 1                     # windows lie inside the grid
    occupied = (args[2].view(-1, kw["cap"]) >= 0).any(dim=1)
    occ_sat = _summed_area_table(occupied.view(*spec.dims).to(torch.int32))
    return (ws.to(torch.int64).prod(-1),
            box_count(occ_sat, anchors, hi).to(torch.int64),
            box_count(index.grid.sat, anchors, hi).to(torch.int64))


def _clusters_in_sparse_cloud(rng):
    """Dense clusters (megacells below full radius) in a sparse cloud
    (full radius): a launch with boxed and ladder tiles."""
    sparse = rng.random((8000, 3))
    centers = rng.random((8, 3))
    dense = (centers[rng.integers(0, 8, 12000)]
             + rng.normal(0.0, 0.03, (12000, 3)))
    return np.clip(np.concatenate([sparse, dense]), 0, 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile", [(8, 256), (32, 40), (8, 1104)])
def test_walk_counts_equal_the_windows_box_counts(card, k, tile):
    pts = _clusters_in_sparse_cloud(np.random.default_rng(7))
    params = api.SearchParams(radius=0.05, k=k, knn_window="exact")
    index, plan, qs = _plan(pts, params, tile)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        args, kw = _inputs(index, plan, qs)
        d2, idx = knn_tile.knn_tile_anchored(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    walk = obs.kernel_counters()["knn_tile_anchored"]
    d2_p, idx_p = knn_tile.knn_tile_anchored_plain(*args, **kw)
    assert torch.equal(d2, d2_p) and torch.equal(idx, idx_p)

    cells, occ, valid = _windows(index, args, kw)
    plevel, table = args[4], args[5]
    boxed = (args[6] != table[plevel.long(), :3]).any(dim=1)
    assert boxed.any() and (~boxed).any()
    n_rb = knn_tile.row_blocks(tile)[0]
    assert walk["query_rows"] == plevel.shape[0] * tile
    assert walk["boxed_rows"] == int(boxed.sum()) * tile
    assert walk["window_cells"] == int(cells.sum()) * n_rb
    assert walk["occupied_cells"] == int(occ.sum()) * n_rb
    assert walk["candidates"] == int(valid.sum()) * n_rb
    assert walk["candidate_pairs"] == int(valid.sum()) * tile
    entries = ops.segment_levels(plan.ladder, tuple(index.spec.dims))
    want = {}
    for lvl in sorted(set(plevel.tolist())):
        ws, skip = entries[lvl]
        for b in (False, True):
            sel = (plevel == lvl) & (boxed == b)
            if sel.any():
                want[(tuple(ws), not skip, b)] = (
                    int(valid[sel].sum()) * tile, int(sel.sum()) * tile)
    got = {(tuple(s["window"]), s["sphere_test"], s["boxed"]):
           (s["candidate_pairs"], s["query_rows"])
           for s in walk["by_signature"]}
    assert got == want

    knn_tile.knn_tile_anchored(*args, **kw)
    again = obs.kernel_counters()["knn_tile_anchored"]
    assert again["candidate_pairs"] == 2 * walk["candidate_pairs"]
    assert again["query_rows"] == 2 * walk["query_rows"]
    assert again["boxed_rows"] == 2 * walk["boxed_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("range", 32), ("knn", 32), ("knn", 8),
                                    ("knn", 129)])
def test_full_radius_boxes_equal_the_ladder_on_card(card, mode, k):
    """A uniform scene like the SPH session's: at k = 32 no megacell is
    found within the inscribed ring, so every tile is at full radius; at
    k = 8 some knn windows are below it; k = 129 runs as two passes. Each
    full-radius tile walks a box no larger than its ladder cube, every
    other tile its cube, and the kernel's rows equal bitwise those on the
    ladder's inputs and the plain version's."""
    pts = np.random.default_rng(11).random((50000, 3)).astype(np.float32)
    params = (api.SearchParams(radius=0.054, k=k, mode="range")
              if mode == "range" else
              api.SearchParams(radius=0.054, k=k, knn_window="exact"))
    index, plan, qs = _plan(pts, params, 256)
    args, kw = _inputs(index, plan, qs)
    ladder = _ladder_args(index, plan, args)
    full = torch.tensor([w == index.statics.w_full and not sk
                         for w, sk in plan.ladder], device="cuda")[
        plan.tile_levels.long()]
    assert full.all() if k >= 32 else (full.any() and (~full).any())
    assert torch.equal(args[3][~full], ladder[3][~full])
    assert torch.equal(args[6][~full], ladder[6][~full])
    cells, cube = args[6][full].prod(1), ladder[6][full].prod(1)
    assert (cells <= cube).all() and (cells < cube).any()
    d2, idx = knn_tile.knn_tile_anchored(*args, **kw)
    d2_l, idx_l = knn_tile.knn_tile_anchored(*ladder, **kw)
    walk = obs.kernel_counters()["knn_tile_anchored"]
    assert torch.equal(d2, d2_l) and torch.equal(idx, idx_l)
    d2_p, idx_p = knn_tile.knn_tile_anchored_plain(*args, **kw)
    assert torch.equal(d2, d2_p) and torch.equal(idx, idx_p)
    assert (idx >= 0).sum(1).float().mean() > min(k, 32) / 2
    boxed = (args[6] != args[5][args[4].long(), :3]).any(dim=1)
    passes = -(-k // knn_tile.MAX_K)
    assert walk["boxed_rows"] == int(boxed.sum()) * plan.tile * passes > 0
