"""The port's ``knn_tile_anchored`` and its launch ladder vs the JAX
reference (Pallas in interpret mode), and the CUDA kernel vs its plain
version (on the card only).

Tolerances: integer outputs (entries, levels, anchors) exact; ``d2``
within atol 1e-6, since the reference sums with a matmul and the port
writes its sums out x, y, z; indices equal except between distances that
tie within 1e-6, and every index must reproduce its distance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grid import build_cell_grid, choose_grid_spec
from repro.kernels import ops as jops
from repro.kernels.knn_tile import knn_tile_anchored as j_knn
from repro_torch.kernels import knn_tile as tknn
from repro_torch.kernels import ops as tops

D2_ATOL = 1e-6


def _grid_fixture(rng, n=500, r=0.15):
    pts = rng.random((n, 3)).astype(np.float32)
    spec = choose_grid_spec(pts, r)
    grid = build_cell_grid(jnp.asarray(pts), spec)
    return pts, spec, np.array(grid.dense).reshape(-1)


def _assert_knn_close(pts, qs, d2_ref, d2, idx_ref, idx):
    np.testing.assert_array_equal(np.isinf(d2_ref), np.isinf(d2))
    fin = np.isfinite(d2)
    np.testing.assert_allclose(d2[fin], d2_ref[fin], atol=D2_ATOL, rtol=0)
    np.testing.assert_array_equal(idx < 0, ~fin)
    # an index may differ only where its distance ties another in the row
    for r, s in zip(*np.nonzero(idx != idx_ref)):
        others = np.delete(d2[r], s)
        assert np.any(np.abs(others - d2[r, s]) <= D2_ATOL), (r, s)
    recompute = np.sum((qs[:, None] - pts[np.clip(idx, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(recompute[fin], d2[fin], atol=1e-5)


ENTRIES = (((3, 3, 3), False), ((5, 4, 6), False), ((7, 7, 7), False))


def _tile_inputs(rng, spec, n_tiles, tile, levels):
    qs = rng.random((n_tiles * tile, 3)).astype(np.float32)
    anchors = np.zeros((n_tiles, 3), np.int32)
    for i, lvl in enumerate(levels):
        ws = ENTRIES[lvl][0] if 0 <= lvl < len(ENTRIES) else (1, 1, 1)
        hi = np.asarray(spec.dims) - np.asarray(ws)
        anchors[i] = rng.integers(0, hi + 1)
    return qs, anchors, np.asarray(levels, np.int32)


def _port_call(qs, pts, dense, anchors, levels, spec, k, r2, tile, skip):
    table = np.asarray([(*ws, int(skip)) for ws, _ in ENTRIES], np.int32)
    t = torch.from_numpy
    d2, idx = tknn.knn_tile_anchored(
        t(qs), t(pts), t(dense), t(anchors), t(levels), t(table),
        dims=spec.dims, cap=spec.capacity, k=k, r2=r2, tile=tile)
    return d2.numpy(), idx.numpy()


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("k", [1, 5, 8, 32])
def test_plain_matches_reference_kernel(rng, k, skip):
    """Three window sizes in one call (m = 27, 120 and 343 cells times the
    capacity: none a multiple of the reference's 512-candidate chunk), and
    one tile whose level lies outside the table, which must come back
    (inf, -1)."""
    tile, r = 16, 0.15
    pts, spec, dense = _grid_fixture(rng)
    levels = [0, 1, 2, -1, 1]
    qs, anchors, levels = _tile_inputs(rng, spec, len(levels), tile, levels)
    d2, idx = _port_call(qs, pts, dense, anchors, levels, spec, k, r * r,
                         tile, skip)
    assert d2.shape == (len(levels) * tile, k) and idx.dtype == np.int32
    rows = np.repeat(levels, tile)
    assert np.isinf(d2[rows == -1]).all() and (idx[rows == -1] == -1).all()
    for e, (ws, _) in enumerate(ENTRIES):
        jd2, jidx = j_knn(
            jnp.asarray(qs), jnp.asarray(pts), jnp.asarray(dense),
            jnp.asarray(anchors), jnp.asarray(levels), level=e, ws=ws,
            dims=spec.dims, cap=spec.capacity, k=k, r2=r * r,
            skip_test=skip, tq=tile)
        sel = rows == e
        _assert_knn_close(pts, qs[sel], np.asarray(jd2)[sel], d2[sel],
                          np.asarray(jidx)[sel], idx[sel])


def test_plain_chunked_merge_equals_one_sort(rng, monkeypatch):
    """The plain version streams each window in chunks; merging the chunks
    must give bitwise what one stable sort over the whole window gives."""
    tile = 8
    pts, spec, dense = _grid_fixture(rng, n=800)
    qs, anchors, levels = _tile_inputs(rng, spec, 3, tile, [2, 0, 1])
    args = (qs, pts, dense, anchors, levels, spec, 8, 0.2 ** 2, tile, False)
    d2_a, idx_a = _port_call(*args)
    monkeypatch.setattr(tknn, "_PLAIN_CHUNK", 37)
    d2_b, idx_b = _port_call(*args)
    np.testing.assert_array_equal(d2_a, d2_b)
    np.testing.assert_array_equal(idx_a, idx_b)


@pytest.mark.parametrize("ladder,dims", [
    (((1, False), (3, False), (4, False)), (203, 203, 11)),
    (((0, True), (1, True), (2, False), (3, False)), (40, 40, 40)),
    (((6, False),), (9, 30, 4)),
])
def test_segment_levels(ladder, dims):
    assert jops.segment_levels(ladder, dims) == \
        tops.segment_levels(ladder, dims)


@pytest.mark.parametrize("ladder", [
    ((1, False), (2, True), (3, False)),
    ((0, False), (2, False), (4, False)),
])
def test_assign_tile_levels(rng, ladder):
    dims = (40, 25, 12)
    entries = jops.segment_levels(ladder, dims)
    n_tiles, tile = 60, 16
    # tiles of clustered cells, some spread wide, some tight
    base = rng.integers(0, np.asarray(dims), (n_tiles, 1, 3))
    spread = rng.integers(0, 12, (n_tiles, 1, 1))
    qc = np.clip(base + rng.integers(0, 1000, (n_tiles, tile, 3))
                 % (spread + 1), 0, np.asarray(dims) - 1).astype(np.int32)
    levels = rng.integers(-1, len(ladder) + 1, (n_tiles,)).astype(np.int32)
    jp, ja = jops.assign_tile_levels(jnp.asarray(qc), jnp.asarray(levels),
                                     ladder, entries, dims)
    tp, ta = tops.assign_tile_levels(torch.from_numpy(qc),
                                     torch.from_numpy(levels), ladder,
                                     entries, dims)
    assert tp.dtype == torch.int32 and ta.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


def test_wrapper_rejects_bad_arguments(rng):
    pts, spec, dense = _grid_fixture(rng)
    qs, anchors, levels = _tile_inputs(rng, spec, 2, 8, [0, 1])
    with pytest.raises(ValueError):           # q rows != n_tiles * tile
        _port_call(qs[:-1], pts, dense, anchors, levels, spec, 4, 0.01, 8,
                   False)
    with pytest.raises(ValueError):           # wrong index dtype
        _port_call(qs, pts, dense.astype(np.int64), anchors, levels, spec,
                   4, 0.01, 8, False)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_kernel_matches_plain_on_card(rng, k):
    """The CUDA kernel must equal its plain version bitwise on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    tile = 64
    pts, spec, dense = _grid_fixture(rng, n=3000)
    qs, anchors, levels = _tile_inputs(rng, spec, 5, tile, [0, 1, 2, -1, 2])
    table = np.asarray([(*ws, int(i == 1)) for i, (ws, _) in
                        enumerate(ENTRIES)], np.int32)
    args = [torch.from_numpy(a).cuda() for a in
            (qs, pts, dense, anchors, levels, table)]
    kw = dict(dims=spec.dims, cap=spec.capacity, k=k, r2=0.15 ** 2,
              tile=tile)
    d2_k, idx_k = tknn.knn_tile_anchored(*args, **kw)
    d2_p, idx_p = tknn.knn_tile_anchored_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p)
