"""PyTorch port vs the JAX reference: megacell statics, per-query windows,
launch-signature ladders and signature levels. ``w_search``, ``skip``,
ladders and levels must match exactly; ``rho`` (a float density
estimate) within rtol 1e-6."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core import partition as jpart
from repro.core.types import SearchParams as JParams
from repro_torch.core import grid as tgrid
from repro_torch.core import partition as tpart
from repro_torch.core.types import SearchParams as TParams

CASES = [
    dict(radius=0.11, k=8, mode="knn", knn_window="exact"),
    dict(radius=0.11, k=8, mode="knn", knn_window="heuristic"),
    dict(radius=0.1, k=8, mode="range"),
    dict(radius=0.2, k=30, mode="knn", knn_window="exact"),
]


def _both(kw):
    return JParams(**kw), TParams(**kw)


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("w_max", [0, 2, 6])
def test_megacell_statics(kw, w_max):
    jp, tp = _both(kw)
    for cell in (0.0275, 0.01, 0.004, 0.3):
        assert (dataclasses.asdict(jpart.megacell_statics(cell, jp, w_max))
                == dataclasses.asdict(tpart.megacell_statics(cell, tp,
                                                             w_max)))


@pytest.mark.parametrize("kw", CASES)
def test_compute_megacells(rng, kw):
    jp, tp = _both(kw)
    pts = rng.random((1500, 3)).astype(np.float32)
    qs = rng.random((300, 3)).astype(np.float32)
    spec_j = jgrid.choose_grid_spec(pts, jp.radius)
    spec_t = tgrid.choose_grid_spec(pts, tp.radius)
    jg = jgrid.build_cell_grid(jnp.asarray(pts), spec_j)
    tg = tgrid.build_cell_grid(torch.from_numpy(pts), spec_t)
    js = jpart.megacell_statics(spec_j.cell_size, jp, 6)
    ts = tpart.megacell_statics(spec_t.cell_size, tp, 6)
    jw, jsk, jrho = jpart.compute_megacells(jg, jnp.asarray(qs), js, jp)
    tw, tsk, trho = tpart.compute_megacells(tg, torch.from_numpy(qs), ts, tp)
    assert tw.dtype == torch.int32 and tsk.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(jsk), tsk.numpy())
    np.testing.assert_allclose(np.asarray(jrho), trho.numpy(), rtol=1e-6)
    # the levels of these windows on the derived ladder
    jl = jpart.launch_signatures(js, jp)
    tl = tpart.launch_signatures(ts, tp)
    assert jl == tl
    np.testing.assert_array_equal(
        np.asarray(jpart.signature_levels(jw, jsk, jl)),
        tpart.signature_levels(tw, tsk, tl).numpy())


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("sig", [dict(), dict(margin=1), dict(margin=3),
                                 dict(enabled=False),
                                 dict(w_ladder=(0, 2)),
                                 dict(w_ladder=(5, 1, 1, 30))])
def test_launch_signatures(kw, sig):
    """knn exact, knn heuristic and range, with margins, partitioning off
    and explicit ladders, on fine and coarse cells."""
    jp, tp = _both(kw)
    for cell in (0.004, 0.0125, 0.0275):
        js = jpart.megacell_statics(cell, jp, 6)
        ts = tpart.megacell_statics(cell, tp, 6)
        assert jpart.launch_signatures(js, jp, **sig) == \
            tpart.launch_signatures(ts, tp, **sig)


@pytest.mark.parametrize("ladder", [
    ((1, False), (2, True), (3, False), (4, False)),
    ((0, False), (2, False), (5, False)),
])
def test_signature_levels(rng, ladder):
    """Exact matches, and (for ladders without skip entries) rounding up
    to the next ladder window, including windows past the last entry."""
    w = rng.integers(0, 7, (500,)).astype(np.int32)
    s = rng.random(500) < 0.3
    np.testing.assert_array_equal(
        np.asarray(jpart.signature_levels(jnp.asarray(w), jnp.asarray(s),
                                          ladder)),
        tpart.signature_levels(torch.from_numpy(w), torch.from_numpy(s),
                               ladder).numpy())
