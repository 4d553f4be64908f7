"""The port's functional query path as a whole vs the JAX reference, on
``tests/test_api.py``'s ``_scene`` workload (n=1500, nq=397, r=0.11, k=8,
exact knn window, query tile 128), in knn and range modes.

Tolerances: grid, plan, counts and inf masks exact; ``d2`` within atol
1e-6 (the reference's own fused and jnp paths differ by up to 4.77e-7);
indices equal except between distances that tie within 1e-6."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import SearchOpts as JOpts, SearchParams as JParams
from repro.reliability.errors import QueryError as JQueryError
import repro_torch.api as tapi
from repro_torch.convert import index_from_arrays, plan_from_arrays
from repro_torch.kernels.ref import brute_force_search

D2_ATOL = 1e-6
MODES = {"knn": dict(radius=0.11, k=8, knn_window="exact"),
         "range": dict(radius=0.1, k=8, mode="range")}


def _scene(rng, n=1500, nq=397):
    return (rng.random((n, 3)).astype(np.float32),
            rng.random((nq, 3)).astype(np.float32))


def _to_torch(jparams, jopts):
    return (tapi.SearchParams(**dataclasses.asdict(jparams)),
            tapi.SearchOpts(**dataclasses.asdict(jopts)))


@pytest.fixture(scope="module")
def runs():
    """The reference run per (mode, use_pallas), computed once: its index,
    its plan and its result (Pallas in interpret mode)."""
    pts, qs = _scene(np.random.default_rng(0))
    out = {}
    for mode, kw in MODES.items():
        for pallas in (True, False):
            jp = JParams(**kw)
            jo = JOpts(use_pallas=pallas, query_tile=128)
            index = japi.build_index(pts, jp, jo)
            plan = japi.plan_query(index, qs)
            res = japi.execute_plan(index, qs, plan)
            out[mode, pallas] = (jp, jo, index, plan, res)
    return pts, qs, out


def _np(res):
    return (np.asarray(res.indices), np.asarray(res.distances2),
            np.asarray(res.counts))


def _t(res):
    return (res.indices.numpy(), res.distances2.numpy(), res.counts.numpy())


def _assert_close(ref, got):
    ri, rd, rc = ref
    gi, gd, gc = got
    np.testing.assert_array_equal(rc, gc)
    np.testing.assert_array_equal(np.isinf(rd), np.isinf(gd))
    fin = np.isfinite(gd)
    np.testing.assert_allclose(gd[fin], rd[fin], atol=D2_ATOL, rtol=0)
    for r, s in zip(*np.nonzero(gi != ri)):
        others = np.delete(gd[r], s)
        assert np.any(np.abs(others - gd[r, s]) <= D2_ATOL), (r, s)


def _carried(index, plan, jp, jo):
    grid = index.grid
    tindex = index_from_arrays(
        np.asarray(index.points), np.asarray(grid.dense),
        np.asarray(grid.counts), np.asarray(grid.sat),
        np.asarray(grid.overflow), np.asarray(index.anchor_points), None,
        spec=dataclasses.asdict(grid.spec), params=dataclasses.asdict(jp),
        opts=dataclasses.asdict(jo), device="cpu")
    tplan = plan_from_arrays(np.asarray(plan.perm),
                             np.asarray(plan.tile_levels), nq=plan.nq,
                             tile=plan.tile, ladder=plan.ladder,
                             device="cpu")
    return tindex, tplan


@pytest.mark.parametrize("mode", list(MODES))
def test_build_index_matches_reference(runs, mode):
    pts, _, out = runs
    jp, jo, index, _, _ = out[mode, True]
    tp, to = _to_torch(jp, jo)
    tindex = tapi.build_index(pts, tp, to, device="cpu")
    assert dataclasses.asdict(tindex.spec) == dataclasses.asdict(index.spec)
    assert dataclasses.asdict(tindex.statics) == \
        dataclasses.asdict(index.statics)
    for name in ("dense", "counts", "sat", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(index.grid, name)),
                                      getattr(tindex.grid, name).numpy())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("opts", [dict(), dict(schedule=False),
                                  dict(partition=False),
                                  dict(w_ladder=(2,)), dict(margin=1)])
def test_plan_query_matches_reference(runs, mode, opts):
    pts, qs, out = runs
    jp, jo, _, _, _ = out[mode, True]
    opts = dict(opts)
    margin = opts.pop("margin", 0)
    jo = dataclasses.replace(jo, **opts)
    tp, to = _to_torch(jp, jo)
    jplan = japi.plan_query(japi.build_index(pts, jp, jo), qs,
                            margin=margin)
    tplan = tapi.plan_query(tapi.build_index(pts, tp, to, device="cpu"),
                            qs, margin=margin)
    assert (tplan.nq, tplan.tile, tplan.ladder) == \
        (jplan.nq, jplan.tile, jplan.ladder)
    assert tplan.perm.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jplan.perm), tplan.perm.numpy())
    np.testing.assert_array_equal(np.asarray(jplan.tile_levels),
                                  tplan.tile_levels.numpy())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("pallas", [True, False])
def test_execute_plan_under_carried_state(runs, mode, pallas):
    """``execute_plan`` under the reference's own index and plan equals the
    reference's result, on the fused path and on the plain path."""
    _, qs, out = runs
    jp, jo, index, plan, res = out[mode, pallas]
    tindex, tplan = _carried(index, plan, jp, jo)
    got = tapi.execute_plan(tindex, qs, tplan)
    _assert_close(_np(res), _t(got))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("pallas", [True, False])
def test_query_matches_brute_force(runs, mode, pallas):
    """knn: distances and counts equal the brute-force oracle; range:
    counts equal it and every index lies within the radius."""
    pts, qs, out = runs
    jp, jo, _, _, _ = out[mode, pallas]
    tp, to = _to_torch(jp, jo)
    got = tapi.query(tapi.build_index(pts, tp, to, device="cpu"), qs)
    oi, od, oc = brute_force_search(torch.from_numpy(pts),
                                    torch.from_numpy(qs), tp.radius, tp.k)
    np.testing.assert_array_equal(oc.numpy(), got.counts.numpy())
    gi, gd = got.indices.numpy(), got.distances2.numpy()
    valid = gi >= 0
    if mode == "knn":
        np.testing.assert_array_equal(od.numpy(), gd)
    assert (gd[valid] <= np.float32(tp.radius) ** 2).all()
    recompute = np.sum((qs[:, None] - pts[np.clip(gi, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(recompute[valid], gd[valid], atol=1e-5)


def test_fused_and_plain_paths_agree_bitwise_on_d2(runs):
    """Both port paths compute each distance with the same elementwise
    ops, so their knn distances agree bitwise."""
    pts, qs, out = runs
    res = []
    for pallas in (True, False):
        jp, jo, _, _, _ = out["knn", pallas]
        tp, to = _to_torch(jp, jo)
        res.append(tapi.query(tapi.build_index(pts, tp, to, device="cpu"),
                              qs))
    assert torch.equal(res[0].distances2, res[1].distances2)
    assert torch.equal(res[0].counts, res[1].counts)


def test_query_concat_splits_identically(runs):
    pts, qs, out = runs
    jp, jo, _, _, _ = out["knn", True]
    tp, to = _to_torch(jp, jo)
    tindex = tapi.build_index(pts, tp, to, device="cpu")
    parts = [qs[:100], qs[100:101], qs[101:]]
    split = tapi.query_concat(tindex, parts)
    whole = tapi.query(tindex, qs)
    assert [r.counts.shape[0] for r in split] == [100, 1, 296]
    for name in ("indices", "distances2", "counts"):
        assert torch.equal(torch.cat([getattr(r, name) for r in split]),
                           getattr(whole, name))
    assert tapi.query_concat(tindex, []) == []


@pytest.mark.parametrize("bounds", [{}, {"lo": 0.0, "hi": 1.0},
                                    {"lo": [0.0, -1.0, 0.0], "hi": 0.9}])
def test_validate_queries_same_reasons(rng, bounds):
    q = rng.random((40, 3)).astype(np.float32) * 1.2 - 0.1
    q[3, 1] = np.nan
    q[7] = np.inf
    q[9, 2] = -1e30
    with pytest.raises(JQueryError) as jerr:
        japi.validate_queries(q, **bounds)
    with pytest.raises(tapi.QueryError) as terr:
        tapi.validate_queries(q, **bounds)
    assert (terr.value.reasons, terr.value.rows, terr.value.nq) == \
        (jerr.value.reasons, jerr.value.rows, jerr.value.nq)
    clean = rng.random((5, 3)).astype(np.float32)
    assert tapi.validate_queries(clean) is clean
    t = torch.from_numpy(q)
    assert tapi.validate_queries(t) is t        # tensors pass unfetched
