"""PyTorch port vs the JAX reference: cell coordinates, Morton codes, the
(level, Morton) schedule, grid planning and the grid build. Every output
here is integer and must match exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import morton as jmorton
from repro.core import schedule as jschedule
from repro.core.types import GridSpec as JGridSpec
from repro_torch.core import grid as tgrid
from repro_torch.core import morton as tmorton
from repro_torch.core import schedule as tschedule
from repro_torch.core.types import GridSpec as TGridSpec


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _specs(origin, cell, dims, cap):
    return (JGridSpec(origin=origin, cell_size=cell, dims=dims, capacity=cap),
            TGridSpec(origin=origin, cell_size=cell, dims=dims, capacity=cap))


def test_cell_of_and_flat_cell_on_boundaries(rng):
    """Positions on and next to cell boundaries, and outside the grid on
    both sides, bin to the reference's cells exactly."""
    origin, cell, dims = (-0.0039018, 0.25, -1.0), 0.0039018, (260, 7, 33)
    js, ts = _specs(origin, cell, dims, 4)
    on = (np.asarray(origin, np.float32)
          + rng.integers(-3, 265, (4000, 3)).astype(np.float32)
          * np.float32(cell))
    jitter = np.nextafter(on, on + rng.choice([-1.0, 1.0], on.shape))
    pos = np.concatenate([on, jitter, rng.random((2000, 3)) * 1.2 - 0.1]
                         ).astype(np.float32)
    jc = js.cell_of(jnp.asarray(pos))
    tc = ts.cell_of(_t(pos))
    assert tc.dtype == torch.int32
    _eq(jc, tc)
    _eq(js.flat_cell(jc), ts.flat_cell(tc))
    o2 = np.asarray([0.1, -0.2, 0.05], np.float32)
    _eq(js.cell_of(jnp.asarray(pos), jnp.asarray(o2)),
        ts.cell_of(_t(pos), _t(o2)))


def test_morton_encode_decode(rng):
    cc = rng.integers(0, 1024, (5000, 3)).astype(np.int32)
    jcode = jmorton.morton_encode(jnp.asarray(cc))
    tcode = tmorton.morton_encode(_t(cc))
    np.testing.assert_array_equal(np.asarray(jcode).astype(np.int64),
                                  tcode.numpy())
    _eq(jmorton.morton_decode(jcode), tmorton.morton_decode(tcode))
    np.testing.assert_array_equal(tmorton.morton_decode(tcode).numpy(), cc)


@pytest.mark.parametrize("morton", [True, False])
def test_schedule_by_level_with_morton_ties(rng, morton):
    """Few distinct cells and levels force long runs of tied keys; the
    stable sorts must reproduce the reference's permutation."""
    cc = rng.integers(0, 3, (700, 3)).astype(np.int32)
    levels = rng.integers(0, 3, (700,)).astype(np.int32)
    _eq(jschedule.schedule_by_level(jnp.asarray(cc), jnp.asarray(levels),
                                    morton=morton),
        tschedule.schedule_by_level(_t(cc), _t(levels), morton=morton))
    jp, ji = jschedule.schedule_cells(jnp.asarray(cc))
    tp, ti = tschedule.schedule_cells(_t(cc))
    _eq(jp, tp)
    _eq(ji, ti)


@pytest.mark.parametrize("kw", [{}, {"cell_size": 0.05},
                                {"domain_margin": 0.1, "max_dim": 32},
                                {"capacity_slack": 1.5}])
def test_choose_grid_spec(rng, kw):
    pts = rng.random((900, 3)).astype(np.float32)
    pts[:, 2] *= 0.04
    js = jgrid.choose_grid_spec(pts, 0.07, **kw)
    ts = tgrid.choose_grid_spec(pts, 0.07, **kw)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)


def _build_both(pts, js, ts, origin=None, valid=None):
    jg = jgrid.build_cell_grid(
        jnp.asarray(pts), js,
        None if origin is None else jnp.asarray(origin),
        None if valid is None else jnp.asarray(valid))
    tg = tgrid.build_cell_grid(
        _t(pts), ts, None if origin is None else _t(origin),
        None if valid is None else _t(valid))
    for name in ("dense", "counts", "sat", "overflow"):
        _eq(getattr(jg, name), getattr(tg, name))
    return jg, tg


def test_build_cell_grid_matches(rng):
    pts = rng.random((1200, 3)).astype(np.float32)
    js = jgrid.choose_grid_spec(pts, 0.1)
    ts = tgrid.choose_grid_spec(pts, 0.1)
    jg, tg = _build_both(pts, js, ts)
    assert int(tg.overflow) == 0


def test_build_cell_grid_capacity_overflow(rng):
    pts = rng.random((1500, 3)).astype(np.float32) * 0.3
    js, ts = _specs((0.0, 0.0, 0.0), 0.1, (4, 4, 4), 3)
    jg, tg = _build_both(pts, js, ts)
    assert int(tg.overflow) > 0


def test_build_cell_grid_valid_and_parked(rng):
    pts = rng.random((800, 3)).astype(np.float32)
    pts[::7] = 1e30                     # parked rows
    valid = ~np.asarray(tgrid.parked_mask(_t(pts)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jgrid.parked_mask(jnp.asarray(pts))), ~valid)
    js = jgrid.choose_grid_spec(pts[valid], 0.1)
    ts = tgrid.choose_grid_spec(pts[valid], 0.1)
    _build_both(pts, js, ts, valid=valid)


def test_build_cell_grid_origin_override(rng):
    pts = rng.random((600, 3)).astype(np.float32) + 2.0
    js = jgrid.choose_grid_spec(pts - 2.0, 0.12)
    ts = tgrid.choose_grid_spec(pts - 2.0, 0.12)
    origin = (np.asarray(js.origin) + 2.0).astype(np.float32)
    _build_both(pts, js, ts, origin=origin)


def test_box_count_and_clamp_box(rng):
    pts = rng.random((1000, 3)).astype(np.float32)
    js = jgrid.choose_grid_spec(pts, 0.15)
    ts = tgrid.choose_grid_spec(pts, 0.15)
    jg, tg = _build_both(pts, js, ts)
    centers = rng.integers(-2, max(js.dims) + 2, (300, 3)).astype(np.int32)
    for w in (0, 1, 3):
        jlo, jhi = jgrid.clamp_box(js, jnp.asarray(centers), w)
        tlo, thi = tgrid.clamp_box(ts, _t(centers), w)
        _eq(jlo, tlo)
        _eq(jhi, thi)
        _eq(jgrid.box_count(jg.sat, jlo, jhi),
            tgrid.box_count(tg.sat, tlo, thi))
