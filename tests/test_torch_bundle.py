"""The port's host planning (``plan_partitions``, ``trivial_plan``,
``inflate_plan_inputs``) and bundling (``core/bundle.py``) vs the JAX
reference, on the same numpy inputs. All of it is host code: plans,
partitions, bundles and costs must be exactly equal.

The reference's ``plan_bundles`` sorts partitions by query count alone
(ROADMAP queue 3), so with tied counts its linear scan can miss the
exhaustive optimum; the port keeps that order on purpose so that its
bundles equal the reference's. The property test holds the port to the
optimum only where counts do not tie, and a separate test pins the tie
case at the reference's cost."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import bundle as jb
from repro.core import partition as jpart
from repro_torch.convert import partition_plan_from_arrays
from repro_torch.core import bundle as tb
from repro_torch.core import partition as tpart


def _parts_equal(jparts, tparts):
    assert [dataclasses.astuple(p) for p in jparts] == \
        [dataclasses.astuple(p) for p in tparts]


def _bundles_equal(jbundles, tbundles):
    assert [dataclasses.astuple(b) for b in jbundles] == \
        [dataclasses.astuple(b) for b in tbundles]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_partitions_matches_reference(seed):
    """Permutation (stable: Morton order kept within a partition) and every
    Partition field, ``rho`` included, equal the reference's."""
    rng = np.random.default_rng(seed)
    n = 500
    w = rng.integers(0, 5, n).astype(np.int32)
    skip = rng.integers(0, 2, n).astype(bool)
    rho = (rng.random(n) * 1e4).astype(np.float32)
    jplan = jpart.plan_partitions(w, skip, rho, w_full=5)
    tplan = tpart.plan_partitions(w, skip, rho, w_full=5)
    np.testing.assert_array_equal(jplan.perm, tplan.perm)
    _parts_equal(jplan.partitions, tplan.partitions)
    assert tplan.w_full == 5 and tplan.num_partitions == jplan.num_partitions


def test_plan_partitions_accepts_tensors():
    import torch
    rng = np.random.default_rng(3)
    w = rng.integers(0, 4, 100).astype(np.int32)
    skip = rng.integers(0, 2, 100).astype(bool)
    rho = np.ones(100, np.float32)
    a = tpart.plan_partitions(w, skip, rho, 5)
    b = tpart.plan_partitions(torch.from_numpy(w), torch.from_numpy(skip),
                              torch.from_numpy(rho), 5)
    np.testing.assert_array_equal(a.perm, b.perm)
    _parts_equal(a.partitions, b.partitions)
    assert sorted(a.perm.tolist()) == list(range(100))
    for p in a.partitions:
        sel = a.perm[p.start:p.start + p.count]
        assert (w[sel] == p.w_search).all() and (skip[sel] == p.skip_test).all()


def test_trivial_plan_and_inflation_match_reference():
    jt, tt = jpart.trivial_plan(37, 4), tpart.trivial_plan(37, 4)
    np.testing.assert_array_equal(jt.perm, tt.perm)
    _parts_equal(jt.partitions, tt.partitions)
    rng = np.random.default_rng(4)
    w = rng.integers(0, 6, 200).astype(np.int32)
    skip = rng.integers(0, 2, 200).astype(bool)
    for margin in (0, 1, 3):
        jw, js = jpart.inflate_plan_inputs(w, skip, margin=margin, w_full=5,
                                           w_sph=2)
        tw, ts = tpart.inflate_plan_inputs(w, skip, margin=margin, w_full=5,
                                           w_sph=2)
        assert tw.dtype == jw.dtype
        np.testing.assert_array_equal(jw, tw)
        np.testing.assert_array_equal(js, ts)


def test_partition_plan_from_arrays():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 4, 80).astype(np.int32)
    jplan = jpart.plan_partitions(w, np.zeros(80, bool),
                                  np.ones(80, np.float32), 4)
    for parts in (jplan.partitions,
                  [dataclasses.asdict(p) for p in jplan.partitions]):
        tplan = partition_plan_from_arrays(jplan.perm, parts, w_full=4)
        np.testing.assert_array_equal(tplan.perm, jplan.perm)
        _parts_equal(jplan.partitions, tplan.partitions)
        assert isinstance(tplan.partitions[0], tpart.Partition)


def _mk_parts(mod, ns, ws):
    """Partitions with the paper's inverse N<->S correlation (the
    reference test's helper, on either package's ``Partition``)."""
    ns = sorted(ns, reverse=True)
    ws = sorted(set(ws))[: len(ns)]
    while len(ws) < len(ns):
        ws.append(ws[-1] + 1)
    out, start = [], 0
    for n, w in zip(ns, ws):
        rho = 8 / ((2 * w + 1) * 0.1) ** 3
        out.append(mod.Partition(w_search=w, skip_test=False, count=n,
                                 rho=rho, start=start))
        start += n
    return out


KW = dict(n_points=50_000, cell_size=0.1, mode="knn", k=8, w_sph=10)
COST_KW = {k: v for k, v in KW.items() if k != "w_sph"}


@given(st.lists(st.integers(1, 10000), min_size=1, max_size=6),
       st.lists(st.integers(1, 8), min_size=1, max_size=6))
@settings(deadline=None, max_examples=40, database=None)
def test_bundling_matches_reference_and_exhaustive(ns, ws):
    """``plan_bundles`` equals the reference's on every example; where no
    two partitions tie on count, it also reaches the exhaustive optimum
    (the appendix-C theorem)."""
    jparts, tparts = _mk_parts(jpart, ns, ws), _mk_parts(tpart, ns, ws)
    jplanned = jb.plan_bundles(jparts, jb.CostModel(), **KW)
    tplanned = tb.plan_bundles(tparts, tb.CostModel(), **KW)
    _bundles_equal(jplanned, tplanned)
    got = tb.total_cost(tplanned, tparts, tb.CostModel(), **COST_KW)
    assert got == jb.total_cost(jplanned, jparts, jb.CostModel(), **COST_KW)
    best, best_cost = tb.exhaustive_best(tparts, tb.CostModel(), **KW)
    jbest, jbest_cost = jb.exhaustive_best(jparts, jb.CostModel(), **KW)
    assert best_cost == jbest_cost
    _bundles_equal(jbest, best)
    if len(set(ns)) == len(ns):
        assert got <= best_cost * (1 + 1e-9), (got, best_cost)


@pytest.mark.parametrize("ns,ws", [([1, 1, 1, 1], [6]), ([5, 5, 2], [1, 3]),
                                   ([100, 50, 10], [1, 2, 3])])
def test_bundling_examples_match_reference(ns, ws):
    """Fixed examples, the tied-count case of the reference's recorded
    counterexample among them."""
    jparts, tparts = _mk_parts(jpart, ns, ws), _mk_parts(tpart, ns, ws)
    for enable in (True, False):
        _bundles_equal(
            jb.plan_bundles(jparts, jb.CostModel(), enable=enable, **KW),
            tb.plan_bundles(tparts, tb.CostModel(), enable=enable, **KW))


def test_bundling_tie_case_keeps_the_reference_fault():
    """ns=[1,1,1,1], ws=[6]: sorting by count alone, the scan plans four
    singletons at 680000.0 while the exhaustive optimum {0},{1},{2,3}
    costs 677531.04 (ROADMAP queue 3, the reference's failing property
    test). The port keeps the reference's bundles and so its cost."""
    parts = _mk_parts(tpart, [1, 1, 1, 1], [6])
    planned = tb.plan_bundles(parts, tb.CostModel(), **KW)
    assert [b.members for b in planned] == [(0,), (1,), (2,), (3,)]
    assert tb.total_cost(planned, parts, tb.CostModel(),
                         **COST_KW) == 680000.0
    best, best_cost = tb.exhaustive_best(parts, tb.CostModel(), **KW)
    assert best_cost == pytest.approx(677531.04, abs=0.01)
    assert best_cost < 680000.0


def test_bundling_disabled_is_listing3():
    parts = _mk_parts(tpart, [100, 50, 10], [1, 2, 3])
    bundles = tb.plan_bundles(parts, tb.CostModel(), enable=False,
                              n_points=1000, cell_size=0.1, mode="knn", k=8,
                              w_sph=10)
    assert len(bundles) == 3 and all(len(b.members) == 1 for b in bundles)


def test_bundle_skip_test_conservative():
    """A merged bundle may only skip the sphere test if every member could
    AND the merged window stays sphere-inscribed."""
    parts = [tpart.Partition(w_search=1, skip_test=True, count=10, rho=1.0,
                             start=0),
             tpart.Partition(w_search=4, skip_test=True, count=5, rho=1.0,
                             start=10)]
    bundles = tb.plan_bundles(parts, tb.CostModel(k_knn=1e12),
                              n_points=100, cell_size=0.1, mode="range", k=8,
                              w_sph=2)
    merged = [b for b in bundles if len(b.members) == 2]
    assert merged and not any(b.skip_test for b in merged)


def test_range_cost_model_prefers_fewer_builds_when_search_cheap():
    kw = dict(n_points=10_000, cell_size=0.1, mode="range", k=8, w_sph=10)
    jparts = _mk_parts(jpart, [1000, 900, 800], [1, 2, 3])
    tparts = _mk_parts(tpart, [1000, 900, 800], [1, 2, 3])
    jm = jb.CostModel(k_range_skip=1e-9, k_range_test=1e-9)
    tm = tb.CostModel(k_range_skip=1e-9, k_range_test=1e-9)
    tplanned = tb.plan_bundles(tparts, tm, **kw)
    assert len(tplanned) == 1
    _bundles_equal(jb.plan_bundles(jparts, jm, **kw), tplanned)


def test_bundle_query_sel_matches_reference():
    rng = np.random.default_rng(6)
    w = rng.integers(0, 4, 120).astype(np.int32)
    rho = rng.random(120).astype(np.float32)
    jplan = jpart.plan_partitions(w, np.zeros(120, bool), rho, 4)
    tplan = tpart.plan_partitions(w, np.zeros(120, bool), rho, 4)
    for members in ((0,), (1, 2), tuple(range(jplan.num_partitions))):
        jbd = jb.Bundle(members=members, w_search=3, skip_test=False,
                        count=0)
        tbd = tb.Bundle(members=members, w_search=3, skip_test=False,
                        count=0)
        np.testing.assert_array_equal(jb.bundle_query_sel(jplan, jbd),
                                      tb.bundle_query_sel(tplan, tbd))
        assert tbd.signature == (3, False)


def test_calibrate_ratios():
    """``calibrate`` turns the two timings into the same ratios as the
    reference (timed functions that return at once)."""
    model = tb.calibrate(lambda: None, 1000, lambda: None, 10.0, repeats=2)
    assert model.k_build == 1.0
    assert model.k_range_skip == pytest.approx(model.k_knn / 20.0)
    assert model.k_range_test == pytest.approx(model.k_knn / 2.0)
