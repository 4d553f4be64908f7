"""The port's grid update path vs the JAX reference: ``bin_disp_tile`` (the
plain version here; the CUDA kernel on the card), ``_bin_and_stats``,
``update_cell_grid`` and ``update_index``.

Tolerances: everything bitwise. Cells, counts and the dense grid are
integers; ``max_disp2`` is compared by its float32 bits. The port sums the
squared displacement x, y, z in float32 (``kernels/ref.sq_dist``), as the
reference's programs do at these sizes. One exception, a quirk of the
reference on the CPU: when the whole input fits one 256-row tile of the
Pallas kernel, XLA contracts the sum in interpret mode into
``fma(dz, dz, fma(dy, dy, dx * dx))``, so there ``max_disp2`` may differ
in its last bit (the ``n1`` case)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import SearchOpts as JOpts, SearchParams as JParams
from repro.core.grid import (_bin_and_stats as j_bin_and_stats,
                             build_cell_grid as j_build_cell_grid,
                             choose_grid_spec as j_choose_grid_spec,
                             update_cell_grid as j_update_cell_grid)
from repro.kernels.update_tile import bin_disp_tile as j_bin_disp_tile
import repro_torch.api as tapi
from repro_torch.core.grid import (_bin_and_stats, build_cell_grid,
                                   update_cell_grid)
from repro_torch.core.types import GridSpec, PARK_SENTINEL
from repro_torch.kernels import update_tile as tup


def _tspec(jspec) -> GridSpec:
    return GridSpec(**dataclasses.asdict(jspec))


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).reshape(()).view(np.int32))


def _tbits(t: torch.Tensor) -> int:
    return int(t.reshape(()).view(torch.int32))


def _drift(rng, pts, sigma):
    return np.clip(pts + rng.normal(0, sigma, pts.shape), 0.0,
                   1.0).astype(np.float32)


def _case(name, rng):
    """(moved, anchor, origin, mask_parked) for one edge case."""
    n = {"n1": 1, "n257": 257}.get(name, 777)
    pts = rng.random((n, 3)).astype(np.float32)
    anchor = _drift(rng, pts, 0.01)
    moved = pts.copy()
    origin, mask = None, False
    if name == "out_of_range":
        moved[7] = [9.0, 9.0, 9.0]            # past every high face
        moved[123] = [-4.0, 0.5, 0.5]         # below the low x face
        moved[200] = [0.5, -0.3, 1.7]         # below y, past z
    elif name in ("parked_masked", "parked_unmasked"):
        moved[[3, 50, 400]] = PARK_SENTINEL
        moved[60] = [0.5, -PARK_SENTINEL, 0.5]
        moved[9] = [9.0, 0.5, 0.5]            # a real escapee as well
        mask = name == "parked_masked"
    elif name == "origin":
        origin = np.float32([-0.05, 0.02, -0.11])
    return moved, anchor, origin, mask


CASES = ["basic", "n1", "n257", "out_of_range", "parked_masked",
         "parked_unmasked", "origin"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_kernel_bitwise(name):
    """``bin_disp_tile_plain`` equals the Pallas kernel (interpret mode):
    cells, out-of-bounds count and the bits of ``max_disp2``."""
    rng = np.random.default_rng(CASES.index(name))
    moved, anchor, origin, mask = _case(name, rng)
    jspec = j_choose_grid_spec(rng.random((500, 3)).astype(np.float32), 0.1)
    jo = None if origin is None else jnp.asarray(origin)
    cj, oj, dj = j_bin_disp_tile(jnp.asarray(moved), jnp.asarray(anchor),
                                 jspec, origin=jo, mask_parked=mask,
                                 interpret=True)
    to = None if origin is None else torch.from_numpy(origin)
    ct, ot, dt = tup.bin_disp_tile_plain(
        torch.from_numpy(moved), torch.from_numpy(anchor), _tspec(jspec),
        origin=to, mask_parked=mask)
    assert ct.dtype == torch.int32 and ct.shape == (moved.shape[0], 3)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert int(oj) == int(ot)
    if moved.shape[0] > 256:
        assert _bits(dj) == _tbits(dt)
    else:                     # XLA's FMA contraction of a one-tile input
        assert abs(_bits(dj) - _tbits(dt)) <= 1
    if name == "out_of_range":
        assert int(ot) == 3
    if name.startswith("parked"):
        assert int(ot) == (1 if mask else 5)
        assert np.isfinite(float(dt)) == mask


def test_wrapper_runs_plain_on_cpu_and_checks_inputs(rng):
    pts = rng.random((40, 3)).astype(np.float32)
    spec = _tspec(j_choose_grid_spec(pts, 0.1))
    p, a = torch.from_numpy(pts), torch.from_numpy(_drift(rng, pts, 0.01))
    before = tup.bin_disp_tile.launches
    got = tup.bin_disp_tile(p, a, spec)
    ref = tup.bin_disp_tile_plain(p, a, spec)
    assert tup.bin_disp_tile.launches == before   # no kernel on the CPU
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="float32"):
        tup.bin_disp_tile(p.double(), a, spec)
    with pytest.raises(ValueError, match="anchor_points"):
        tup.bin_disp_tile(p, a[:-1], spec)
    with pytest.raises(ValueError, match="origin"):
        tup.bin_disp_tile(p, a, spec, origin=torch.zeros(2))


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("origin", [False, True])
def test_bin_and_stats_matches_jax_bitwise(rng, valid, origin):
    """The plain path vs the reference's ``_bin_and_stats``, run op by op
    as written: it divides by the cell size. (Under ``jit`` XLA turns that
    division into a multiply by the float32 reciprocal, which can move a
    point on a cell boundary; see the boundary test below.)"""
    pts = rng.random((900, 3)).astype(np.float32)
    jspec = j_choose_grid_spec(pts, 0.1)
    anchor = _drift(rng, pts, 0.02)
    moved = pts.copy()
    moved[11] = [2.0, 0.5, 0.5]
    moved[12] = [0.5, 0.5, -1.0]
    vmask = rng.random(900) > 0.2 if valid else None
    o = np.float32([0.01, -0.02, 0.03]) if origin else None
    cj, oj, dj = j_bin_and_stats(jspec, jnp.asarray(moved),
                                 jnp.asarray(anchor),
                    None if o is None else jnp.asarray(o),
                    None if vmask is None else jnp.asarray(vmask))
    ct, ot, dt = _bin_and_stats(
        _tspec(jspec), torch.from_numpy(moved), torch.from_numpy(anchor),
        None if o is None else torch.from_numpy(o),
        None if vmask is None else torch.from_numpy(vmask))
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert int(oj) == int(ot)
    assert _bits(dj) == _tbits(dt)


def _boundary_point(spec):
    """An x coordinate where ``floor((x - o) * f32(1/cell))`` and
    ``floor((x - o) / f32(cell))`` disagree: the first one among the
    float32 values within 64 ulps of a cell boundary."""
    cell = np.float32(spec.cell_size)
    inv = np.float32(1.0 / spec.cell_size)
    o = np.float32(spec.origin[0])
    x = (o + np.arange(1, spec.dims[0] - 1, dtype=np.float32) * cell
         ).astype(np.float32)
    bits = x.view(np.int32)[:, None] + np.arange(-64, 65, dtype=np.int32)
    x = bits.view(np.float32).reshape(-1)
    d = (x - o).astype(np.float32)
    differ = np.floor(d * inv) != np.floor(d / cell)
    assert differ.any(), "no boundary point found"
    return x[np.argmax(differ)]


def test_each_path_follows_its_own_reference_at_a_boundary(rng):
    """The Pallas path multiplies by ``f32(1/cell)``, the plain path divides
    by ``f32(cell)``. At a boundary point the two put the point in
    different cells, and each port path agrees with its reference path:
    the Pallas kernel, and ``_bin_and_stats`` run op by op as written."""
    pts = rng.random((300, 3)).astype(np.float32)
    jspec = j_choose_grid_spec(pts, 0.07)
    x = _boundary_point(jspec)
    moved = pts.copy()
    moved[5, 0] = x
    anchor = pts.copy()
    cjp = np.asarray(j_bin_disp_tile(jnp.asarray(moved), jnp.asarray(anchor),
                                     jspec, interpret=True)[0])
    cjj = np.asarray(j_bin_and_stats(jspec, jnp.asarray(moved),
                                     jnp.asarray(anchor))[0])
    spec = _tspec(jspec)
    ctp = tup.bin_disp_tile_plain(torch.from_numpy(moved),
                                  torch.from_numpy(anchor), spec)[0].numpy()
    ctj = _bin_and_stats(spec, torch.from_numpy(moved),
                         torch.from_numpy(anchor))[0].numpy()
    assert cjp[5, 0] != cjj[5, 0]
    np.testing.assert_array_equal(ctp, cjp)
    np.testing.assert_array_equal(ctj, cjj)
    # the division path is the one the static build and cell_of use
    np.testing.assert_array_equal(ctj, spec.cell_of(
        torch.from_numpy(moved)).numpy())


@pytest.mark.parametrize("donate", [False, True])
def test_update_cell_grid_matches_fresh_build(rng, donate):
    """The incremental update produces the structure a fresh build over the
    moved points would (port of ``test_dynamic.py:334``); donation writes
    it into the old grid's storage."""
    pts = rng.random((1000, 3)).astype(np.float32)
    spec = _tspec(j_choose_grid_spec(pts, 0.1, capacity_slack=2.0))
    tp = torch.from_numpy(pts)
    grid = build_cell_grid(tp, spec)
    old_ptr = grid.dense.data_ptr()
    moved = torch.from_numpy(_drift(rng, pts, 0.01))
    g2, stats, ccoord = update_cell_grid(grid, moved, tp, donate=donate)
    fresh = build_cell_grid(moved, spec)
    for name in ("dense", "counts", "sat", "overflow"):
        assert torch.equal(getattr(g2, name), getattr(fresh, name)), name
    assert (g2.dense.data_ptr() == old_ptr) == donate
    assert torch.equal(ccoord, spec.cell_of(moved))
    assert int(stats.oob) == 0
    d2 = np.max(np.sum((moved.numpy() - pts) ** 2, axis=-1))
    np.testing.assert_allclose(float(stats.max_disp2), d2, rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mask_parked", [False, True])
def test_update_cell_grid_matches_reference(rng, use_pallas, mask_parked):
    """Grid, counters and cells of one update equal the reference's, on
    both binning paths, with escapees and parked rows."""
    pts = rng.random((1200, 3)).astype(np.float32)
    jspec = j_choose_grid_spec(pts, 0.1, capacity_slack=1.0)
    moved = _drift(rng, pts, 0.01)
    moved[4] = [1.5, 0.5, 0.5]
    moved[[20, 21]] = PARK_SENTINEL
    moved[30:60] = moved[29]                      # overflow one cell
    jg = j_build_cell_grid(jnp.asarray(pts), jspec)
    jg2, js, jc = j_update_cell_grid(jg, jnp.asarray(moved),
                                     jnp.asarray(pts), use_pallas=use_pallas,
                                     mask_parked=mask_parked)
    spec = _tspec(jspec)
    tg = build_cell_grid(torch.from_numpy(pts), spec)
    tg2, ts, tc = update_cell_grid(tg, torch.from_numpy(moved),
                                   torch.from_numpy(pts),
                                   use_pallas=use_pallas,
                                   mask_parked=mask_parked)
    for name in ("dense", "counts", "sat", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jg2, name)),
                                      getattr(tg2, name).numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert int(js.overflow) == int(ts.overflow) > 0
    assert int(js.oob) == int(ts.oob) == (1 if mask_parked else 3)
    assert _bits(js.max_disp2) == _tbits(ts.max_disp2)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_update_index_matches_reference(rng, use_pallas):
    """``update_index`` re-bins, keeps the anchor, and reports the
    reference's counters; ``with_anchor`` re-anchors."""
    pts = rng.random((800, 3)).astype(np.float32)
    moved = _drift(rng, pts, 0.003)
    jp = JParams(radius=0.1, k=8)
    jo = JOpts(use_pallas=use_pallas, query_tile=128)
    jidx = japi.build_index(pts, jp, jo)
    jidx2, js = japi.update_index(jidx, moved)
    tidx = tapi.build_index(pts, tapi.SearchParams(**dataclasses.asdict(jp)),
                            tapi.SearchOpts(**dataclasses.asdict(jo)),
                            device="cpu")
    tidx2, ts = tapi.update_index(tidx, moved)
    for name in ("dense", "counts", "sat", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jidx2.grid, name)),
                                      getattr(tidx2.grid, name).numpy())
    assert torch.equal(tidx2.anchor_points, tidx.points)
    np.testing.assert_array_equal(tidx2.points.numpy(), moved)
    assert (int(js.oob), int(js.overflow)) == (int(ts.oob), int(ts.overflow))
    assert _bits(js.max_disp2) == _tbits(ts.max_disp2)
    re = tidx2.with_anchor(tidx2.points)
    assert re.anchor_points is tidx2.points and re.grid is tidx2.grid


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name):
    """The CUDA kernel must equal its plain version bitwise on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(CASES.index(name))
    moved, anchor, origin, mask = _case(name, rng)
    spec = _tspec(j_choose_grid_spec(rng.random((500, 3)).astype(
        np.float32), 0.1))
    p, a = torch.from_numpy(moved).cuda(), torch.from_numpy(anchor).cuda()
    o = None if origin is None else torch.from_numpy(origin).cuda()
    before = tup.bin_disp_tile.launches
    got = tup.bin_disp_tile(p, a, spec, origin=o, mask_parked=mask)
    ref = tup.bin_disp_tile_plain(p, a, spec, origin=o, mask_parked=mask)
    torch.cuda.synchronize()
    assert tup.bin_disp_tile.launches == before + 1
    assert torch.equal(got[0], ref[0])
    assert int(got[1]) == int(ref[1])
    assert _tbits(got[2]) == _tbits(ref[2])
