"""The walk counter of ``knn_tile_anchored``'s kernel, on the card: what
it counts (query rows, window cells, occupied cells, candidate ids,
candidate pairs), in all and by launch signature, equals as integers what
the launch's windows hold by the grid's summed-area tables (the pairs are
``chip_smoke.knn_work``'s: valid candidates times the tile; a tile of
several row blocks walks its window once a block); launches add up; the
outputs stay the plain version's bitwise; and neither the launch nor its
counting synchronises with the host before ``kernel_counters`` is
called."""
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


def _launch(k, tile):
    """The one ``knn_tile_anchored`` launch of ``api.execute_plan`` for a
    self-query of 20,000 points, and the index it searches."""
    rng = np.random.default_rng(7)
    pts = rng.random((20000, 3)).astype(np.float32)
    params = api.SearchParams(radius=0.05, k=k, knn_window="exact")
    index = api.build_index(pts, params,
                            api.SearchOpts(use_pallas=True, query_tile=tile),
                            device="cuda")
    plan = api.plan_query(index, index.points)
    qs = index.points[plan.perm.long()]
    args, kw = ops.launch_inputs(index.grid, index.points, qs, index.spec,
                                 plan.ladder, plan.tile_levels,
                                 params.radius, k, plan.tile, index.origin)
    entries = ops.segment_levels(tuple(plan.ladder), tuple(index.spec.dims))
    return index, args, kw, entries


def _windows(index, args, kw):
    """Per tile: window cells, occupied cells and valid candidates."""
    spec, anchors, plevel = index.spec, args[3], args[4]
    ws = args[5][plevel.long(), :3]
    hi = anchors + ws - 1                     # anchors keep windows inside
    occupied = (args[2].view(-1, kw["cap"]) >= 0).any(dim=1)
    occ_sat = _summed_area_table(occupied.view(*spec.dims).to(torch.int32))
    return (ws.to(torch.int64).prod(-1),
            box_count(occ_sat, anchors, hi).to(torch.int64),
            box_count(index.grid.sat, anchors, hi).to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile", [(8, 256), (32, 40), (8, 1104)])
def test_walk_counts_equal_the_windows_box_counts(card, k, tile):
    index, args, kw, entries = _launch(k, tile)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d2, idx = knn_tile.knn_tile_anchored(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    walk = obs.kernel_counters()["knn_tile_anchored"]
    d2_p, idx_p = knn_tile.knn_tile_anchored_plain(*args, **kw)
    assert torch.equal(d2, d2_p) and torch.equal(idx, idx_p)

    cells, occ, valid = _windows(index, args, kw)
    plevel = args[4]
    n_rb = knn_tile.row_blocks(tile)[0]
    assert walk["query_rows"] == plevel.shape[0] * tile
    assert walk["window_cells"] == int(cells.sum()) * n_rb
    assert walk["occupied_cells"] == int(occ.sum()) * n_rb
    assert walk["candidates"] == int(valid.sum()) * n_rb
    assert walk["candidate_pairs"] == int(valid.sum()) * tile
    want = {}
    for lvl in sorted(set(plevel.tolist())):
        ws, skip = entries[lvl]
        want[(tuple(ws), not skip)] = int(valid[plevel == lvl].sum()) * tile
    got = {(tuple(s["window"]), s["sphere_test"]): s["candidate_pairs"]
           for s in walk["by_signature"]}
    assert got == want

    knn_tile.knn_tile_anchored(*args, **kw)
    again = obs.kernel_counters()["knn_tile_anchored"]
    assert again["candidate_pairs"] == 2 * walk["candidate_pairs"]
    assert again["query_rows"] == 2 * walk["query_rows"]
