"""The port's kernel layer (``knn_tile``, ``range_count``,
``distance_tile``) vs the JAX reference's kernels (Pallas in interpret
mode) on the cases of ``tests/test_kernels.py``; the anchored and
id-stream knn kernels against each other; the build's staleness rule; and
each CUDA kernel vs its plain version (on the card only).

Tolerances: ``d2`` within atol 1e-6 (the reference sums with a matmul, the
port writes its sums out x, y, z); bf16 inputs are compared in float32
after the same upcast, so the same tolerance holds; range counts exact;
indices equal except between distances that tie within 1e-6, and every
index must reproduce its distance. Kernel vs plain version: bitwise."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grid import build_cell_grid, choose_grid_spec
from repro.kernels.distance_tile import distance_tile as j_distance
from repro.kernels.knn_tile import knn_tile as j_knn
from repro.kernels.range_tile import range_count as j_range
from repro.kernels.ref import range_count_ref as j_range_ref
from repro_torch.kernels import build, ops
from repro_torch.kernels import distance_tile as tdist
from repro_torch.kernels import knn_tile as tknn
from repro_torch.kernels import range_tile as trange

D2_ATOL = 1e-6
t = torch.from_numpy


def _assert_rows_close(d2_ref, d2, idx_ref, idx):
    np.testing.assert_array_equal(np.isinf(d2_ref), np.isinf(d2))
    fin = np.isfinite(d2)
    np.testing.assert_allclose(d2[fin], d2_ref[fin], atol=D2_ATOL, rtol=0)
    np.testing.assert_array_equal(idx < 0, ~fin)
    # an index may differ only where its distance ties another in the row
    for r, s in zip(*np.nonzero(idx != idx_ref)):
        others = np.delete(d2[r], s)
        assert np.any(np.abs(others - d2[r, s]) <= D2_ATOL), (r, s)


def _assert_knn_close(pts, qs, d2_ref, d2, idx_ref, idx):
    _assert_rows_close(d2_ref, d2, idx_ref, idx)
    fin = np.isfinite(d2)
    recompute = np.sum((qs[:, None] - pts[np.clip(idx, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(recompute[fin], d2[fin], atol=1e-5)


def _knn_both(q, p, wnd, *, k, r2, tile, skip=False):
    """The reference kernel and the port's wrapper (its plain version on
    these CPU tensors) on the same inputs."""
    jd2, jidx = j_knn(jnp.asarray(q), jnp.asarray(p), jnp.asarray(wnd), k=k,
                      r2=r2, skip_test=skip, tq=tile, tm=128)
    d2, idx = ops.knn_tile(t(q), t(p), t(wnd), k=k, r2=r2, skip_test=skip,
                           tile=tile)
    assert d2.shape == (q.shape[0], k) and idx.dtype == torch.int32
    return np.asarray(jd2), np.asarray(jidx), d2.numpy(), idx.numpy()


# ---------------------------------------------------------------------------
# distance_tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,npts", [(8, 16), (100, 300), (256, 512),
                                     (33, 700), (513, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distance_tile_matches_reference(rng, nq, npts, dtype):
    jq = jnp.asarray(rng.random((nq, 3)), dtype)
    jp = jnp.asarray(rng.random((npts, 3)), dtype)
    ref = np.asarray(j_distance(jq, jp, tq=32, tp=128))
    # the same values on both sides: the reference's rounding to the input
    # type, carried over exactly through float32
    q, p = (t(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
            for a in (jq, jp))
    got = ops.distance_tile(q, p)
    assert got.dtype == torch.float32 and got.shape == (nq, npts)
    np.testing.assert_allclose(got.numpy(), ref, atol=D2_ATOL, rtol=0)


def test_distance_tile_rejects_bad_arguments():
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        ops.distance_tile(q, torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        ops.distance_tile(q, torch.zeros((4, 3), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.distance_tile(q.double(), q.double())


# ---------------------------------------------------------------------------
# knn_tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 8, 32])
@pytest.mark.parametrize("m", [60, 256, 1000])
def test_knn_tile_matches_reference(rng, k, m):
    q = rng.random((128, 3)).astype(np.float32)
    p = rng.random((m, 3)).astype(np.float32)
    wnd = np.broadcast_to(np.arange(m, dtype=np.int32), (2, m)).copy()
    jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=k, r2=0.4 * 0.4, tile=64)
    _assert_knn_close(p, q, jd2, d2, jidx, idx)


@pytest.mark.parametrize("k", [1, 5, 8, 100])
def test_knn_tile_large_k_matches_reference(rng, k):
    """The reference's lane-padded K cases: k up to 100."""
    q = rng.random((128, 3)).astype(np.float32)
    p = rng.random((400, 3)).astype(np.float32)
    wnd = np.broadcast_to(np.arange(400, dtype=np.int32), (2, 400)).copy()
    jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=k, r2=0.5 * 0.5, tile=64)
    _assert_knn_close(p, q, jd2, d2, jidx, idx)


def test_knn_tile_k_exceeds_candidates(rng):
    q = rng.random((64, 3)).astype(np.float32)
    p = rng.random((5, 3)).astype(np.float32)
    wnd = np.arange(5, dtype=np.int32)[None]
    jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=8, r2=10.0, tile=64)
    assert (idx[:, 5:] == -1).all() and np.isinf(d2[:, 5:]).all()
    _assert_knn_close(p, q, jd2, d2, jidx, idx)


def test_knn_tile_all_masked(rng):
    q = rng.random((64, 3)).astype(np.float32)
    p = np.full((64, 3), 50.0, np.float32)
    wnd = np.full((1, 64), -1, np.int32)
    jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=4, r2=0.01, tile=64)
    assert (idx == -1).all() and (jidx == -1).all() and np.isinf(d2).all()


def test_knn_tile_duplicate_points():
    q = np.zeros((64, 3), np.float32)
    p = np.zeros((10, 3), np.float32)        # all identical at the query
    wnd = np.arange(10, dtype=np.int32)[None]
    jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=4, r2=1.0, tile=64)
    assert np.allclose(d2, 0.0)
    # ties keep stream order: the first four ids, as the reference has them
    np.testing.assert_array_equal(idx, jidx)
    assert idx[0].tolist() == [0, 1, 2, 3]


def test_knn_tile_skip_test_and_clipped_ids(rng):
    """``skip_test`` keeps out-of-radius candidates; an id past the table
    gathers the last point but keeps its id, as the reference's clip
    does."""
    q = rng.random((64, 3)).astype(np.float32)
    p = rng.random((50, 3)).astype(np.float32)
    wnd = np.concatenate([np.arange(50), [60, -1, 7]]).astype(np.int32)[None]
    for skip in (False, True):
        jd2, jidx, d2, idx = _knn_both(q, p, wnd, k=6, r2=1e-3, tile=64,
                                       skip=skip)
        _assert_rows_close(jd2, d2, jidx, idx)
        assert np.isfinite(d2).all() == skip
    assert (idx == 60).any()


def test_knn_tile_rejects_bad_arguments(rng):
    q = t(rng.random((64, 3)).astype(np.float32))
    p = t(rng.random((10, 3)).astype(np.float32))
    wnd = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError):          # q rows != n_tiles * tile
        ops.knn_tile(q[:-1], p, wnd, k=4, r2=0.1, tile=64)
    with pytest.raises(ValueError):          # wrong id dtype
        ops.knn_tile(q, p, wnd.long(), k=4, r2=0.1, tile=64)
    with pytest.raises(ValueError):
        ops.knn_tile(q, p, wnd, k=0, r2=0.1, tile=64)


def _grid_fixture(rng, n=500, r=0.15):
    pts = rng.random((n, 3)).astype(np.float32)
    spec = choose_grid_spec(pts, r)
    grid = build_cell_grid(jnp.asarray(pts), spec)
    return pts, spec, np.array(grid.dense).reshape(-1)


def _window_ids(dense, spec, anchor, ws):
    """The ids of an anchored window in window order: cells in (x, y, z)
    raster order, slots innermost; the id stream the anchored kernel
    derives inside itself."""
    cap, (_, dy, dz) = spec.capacity, spec.dims
    ix, iy, iz = np.meshgrid(*(np.arange(w) for w in ws), indexing="ij")
    cells = (((anchor[0] + ix) * dy + anchor[1] + iy) * dz
             + anchor[2] + iz).reshape(-1)
    return dense.reshape(-1, cap)[cells].reshape(-1).astype(np.int32)


def _queries_in(rng, spec, anchors, ws, tile):
    """``tile`` queries per anchor, uniform over its window's cells."""
    cells = anchors[:, None, :] + rng.random((len(anchors), tile, 3)) * ws
    return (np.asarray(spec.origin) + cells * spec.cell_size).reshape(
        -1, 3).astype(np.float32)


@pytest.mark.parametrize("k", [4, 5])
def test_anchored_matches_id_stream_on_whole_grid(rng, k):
    """``knn_tile_plain`` fed the flattened grid as the id stream equals
    ``knn_tile_anchored_plain`` over the whole-grid window bitwise (the
    reference's ``test_knn_tile_anchored_matches_id_stream_kernel`` and its
    odd-K variant)."""
    pts, spec, dense = _grid_fixture(rng)
    qs = rng.random((64, 3)).astype(np.float32)
    table = np.asarray([(*spec.dims, 0)], np.int32)
    d2a, idxa = tknn.knn_tile_anchored(
        t(qs), t(pts), t(dense), torch.zeros((1, 3), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32), t(table), t(table[:, :3]),
        dims=spec.dims, cap=spec.capacity, k=k, r2=0.15 ** 2, tile=64)
    d2b, idxb = ops.knn_tile(t(qs), t(pts), t(dense)[None], k=k,
                             r2=0.15 ** 2, tile=64)
    assert torch.equal(d2a, d2b) and torch.equal(idxa, idxb)


def test_anchored_matches_id_stream_on_sub_windows(rng):
    """The same bitwise agreement on windows smaller than the grid, at
    anchors inside it, two tiles per launch, with and without the sphere
    test."""
    pts, spec, dense = _grid_fixture(rng, n=900)
    ws = (8, 9, 7)
    anchors = np.asarray([[0, 0, 0], np.subtract(spec.dims, ws)], np.int32)
    qs = _queries_in(rng, spec, anchors, ws, 32)
    wnd = np.stack([_window_ids(dense, spec, a, ws) for a in anchors])
    for skip in (0, 1):
        table = np.asarray([(*ws, skip)], np.int32)
        d2a, idxa = tknn.knn_tile_anchored(
            t(qs), t(pts), t(dense), t(anchors),
            torch.zeros((2,), dtype=torch.int32), t(table),
            t(np.repeat(table[:, :3], 2, axis=0)), dims=spec.dims,
            cap=spec.capacity, k=6, r2=0.2 ** 2, tile=32)
        d2b, idxb = ops.knn_tile(t(qs), t(pts), t(wnd), k=6, r2=0.2 ** 2,
                                 skip_test=bool(skip), tile=32)
        assert torch.equal(d2a, d2b) and torch.equal(idxa, idxb)
        assert (idxa >= 0).any()


# ---------------------------------------------------------------------------
# range_count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,tm", [(100, 128), (600, 256)])
def test_range_count_matches_reference(rng, m, tm):
    q = rng.random((128, 3)).astype(np.float32)
    p = rng.random((m, 3)).astype(np.float32)
    pos = np.broadcast_to(p, (2, m, 3)).copy()
    wnd = np.broadcast_to(np.arange(m, dtype=np.int32), (2, m)).copy()
    wnd[1, ::5] = -1                         # masked ids count nothing
    r = 0.25
    ref = np.asarray(j_range(jnp.asarray(q), jnp.asarray(pos),
                             jnp.asarray(wnd), r2=r * r, tq=64, tm=tm))
    got = ops.range_count(t(q), t(pos), t(wnd), r2=r * r, tile=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy()[:64], np.asarray(j_range_ref(jnp.asarray(q[:64]),
                                                 jnp.asarray(p), r)))


def test_range_count_plain_chunks(rng, monkeypatch):
    """The plain version counts in chunks of candidates; the chunking must
    not change a count."""
    q = rng.random((32, 3)).astype(np.float32)
    pos = rng.random((1, 300, 3)).astype(np.float32)
    wnd = np.arange(300, dtype=np.int32)[None]
    a = trange.range_count_plain(t(q), t(pos), t(wnd), r2=0.09, tile=32)
    monkeypatch.setattr(trange, "_PLAIN_CHUNK", 37)
    b = trange.range_count_plain(t(q), t(pos), t(wnd), r2=0.09, tile=32)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def test_build_rebuilds_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A library is stale when it is older than its own source or than any
    header in ``csrc/``; touching a header marks every library stale."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("#pragma once\n")
    assert build._stale("a") and build._stale("b")       # never built
    for name in ("a", "b"):
        build.library_path(name).write_bytes(b"")
    past = os.stat(build.library_path("a")).st_mtime - 100
    for f in csrc.iterdir():
        os.utime(f, (past, past))
    assert not build._stale("a") and not build._stale("b")
    os.utime(csrc / "a.cu")                               # one source
    assert build._stale("a") and not build._stale("b")
    os.utime(csrc / "a.cu", (past, past))
    os.utime(csrc / "shared.cuh")                         # the header
    assert build._stale("a") and build._stale("b")


def test_build_force_rebuilds_fresh_libraries(tmp_path, monkeypatch):
    """``build(force=True)`` compiles even a library that is not stale (so
    that a caller always gets nvcc's register report); without it a fresh
    library is left alone. nvcc is stood in for by a process that writes
    its output file."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    (csrc / "a.cu").write_text("")
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.returncode = 0
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info    : Used 7 registers", None

    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    assert build.build(["a"]) == {"a": "ptxas info    : Used 7 registers"}
    assert build.build(["a"]) == {} and len(calls) == 1   # fresh: skipped
    assert "a" in build.build(["a"], force=True) and len(calls) == 2


# ---------------------------------------------------------------------------
# the CUDA kernels vs their plain versions (on the card)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 100])
def test_knn_tile_kernel_matches_plain_on_card(rng, k):
    _need_card()
    q = rng.random((3 * 64, 3)).astype(np.float32)
    p = rng.random((3000, 3)).astype(np.float32)
    wnd = rng.integers(-1, 3000, (3, 1500)).astype(np.int32)
    wnd[2] = -1
    args = [t(a).cuda() for a in (q, p, wnd)]
    for skip in (False, True):
        kw = dict(k=k, r2=0.2 ** 2, skip_test=skip, tile=64)
        d2_k, idx_k = ops.knn_tile(*args, **kw)
        d2_p, idx_p = tknn.knn_tile_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p)


@pytest.mark.cuda
def test_anchored_and_id_stream_kernels_agree_on_card(rng):
    _need_card()
    pts, spec, dense = _grid_fixture(rng, n=3000)
    ws = (8, 6, 9)
    hi = np.subtract(spec.dims, ws)
    anchors = np.asarray([[0, 0, 0], hi // 2, hi], np.int32)
    qs = _queries_in(rng, spec, anchors, ws, 64)
    wnd = np.stack([_window_ids(dense, spec, a, ws) for a in anchors])
    table = np.asarray([(*ws, 0)], np.int32)
    c = [t(a).cuda() for a in (qs, pts, dense, anchors, table, wnd)]
    levels = torch.zeros((3,), dtype=torch.int32, device="cuda")
    d2a, idxa = tknn.knn_tile_anchored(
        c[0], c[1], c[2], c[3], levels, c[4],
        tknn.table_extents(levels, c[4]), dims=spec.dims,
        cap=spec.capacity, k=8, r2=0.15 ** 2, tile=64)
    d2b, idxb = ops.knn_tile(c[0], c[1], c[5], k=8, r2=0.15 ** 2, tile=64)
    torch.cuda.synchronize()
    assert torch.equal(d2a, d2b) and torch.equal(idxa, idxb)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [100, 600])
def test_range_count_kernel_matches_plain_on_card(rng, m):
    _need_card()
    q = rng.random((128, 3)).astype(np.float32)
    pos = rng.random((2, m, 3)).astype(np.float32)
    wnd = rng.integers(-1, m, (2, m)).astype(np.int32)
    args = [t(a).cuda() for a in (q, pos, wnd)]
    got = ops.range_count(*args, r2=0.25 ** 2, tile=64)
    ref = trange.range_count_plain(*args, r2=0.25 ** 2, tile=64)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,npts", [(8, 16), (513, 129), (33, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distance_tile_kernel_matches_plain_on_card(rng, nq, npts, dtype):
    _need_card()
    q = t(rng.random((nq, 3)).astype(np.float32)).to("cuda", dtype)
    p = t(rng.random((npts, 3)).astype(np.float32)).to("cuda", dtype)
    got = ops.distance_tile(q, p)
    ref = tdist.distance_tile_plain(q, p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 40, 2048])
@pytest.mark.parametrize("k", [129, 300])
def test_knn_tile_kernel_any_k_and_tile_on_card(rng, k, tile):
    """A top-k longer than one launch keeps (passes of 128 columns) on
    tiles that are not a whole number of warps (8, 40) or exceed a CTA's
    1024 rows (2048, two row blocks): bitwise the plain version. Half the
    points are duplicated at other ids (ties on d2, by stream position,
    across the pass boundaries too); tile 1's stream holds 100 valid ids
    (fewer than k), tile 2's none."""
    _need_card()
    q = rng.random((3 * tile, 3)).astype(np.float32)
    p = rng.random((3000, 3)).astype(np.float32)
    p[1500:] = p[:1500]
    q[::5] = p[rng.integers(0, 3000, q[::5].shape[0])]
    wnd = rng.integers(-1, 3000, (3, 1500)).astype(np.int32)
    wnd[1, 100:] = -1
    wnd[2] = -1
    args = [t(a).cuda() for a in (q, p, wnd)]
    for skip in (False, True):
        kw = dict(k=k, r2=0.3 ** 2, skip_test=skip, tile=tile)
        before = tknn.knn_tile.launches
        d2_k, idx_k = ops.knn_tile(*args, **kw)
        d2_p, idx_p = tknn.knn_tile_plain(*args, **kw)
        torch.cuda.synchronize()
        assert tknn.knn_tile.launches == before + -(-k // tknn.MAX_K)
        assert torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p), skip
        assert torch.isinf(d2_p[tile:2 * tile, 100:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 40, 2048])
@pytest.mark.parametrize("m", [100, 600])
def test_range_count_kernel_any_tile_on_card(rng, m, tile):
    """Tiles that are not a whole number of warps, or exceed 1024 rows: the
    count of every row (and of no row past the tile) equals the plain
    version's."""
    _need_card()
    q = rng.random((3 * tile, 3)).astype(np.float32)
    pos = rng.random((3, m, 3)).astype(np.float32)
    wnd = rng.integers(-1, m, (3, m)).astype(np.int32)
    args = [t(a).cuda() for a in (q, pos, wnd)]
    got = ops.range_count(*args, r2=0.25 ** 2, tile=tile)
    ref = trange.range_count_plain(*args, r2=0.25 ** 2, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
