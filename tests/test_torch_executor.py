"""The port's host-planned path (``NeighborSearch`` -> ``QueryExecutor``)
vs the JAX reference's, and the executor's contract tests of
``tests/test_executor.py`` run on the port.

Tolerances (ROADMAP north star): counts, inf masks, plans, bundles and
launch groups exact; ``d2`` within atol 1e-6 (the reference sums with a
matmul or ``jnp.sum``, the port writes its sums out x, y, z); indices
equal except between distances that tie within 1e-6. Port vs port (host
loop vs executor, replays, repeats): bitwise."""
import dataclasses
import itertools
import warnings

import numpy as np
import pytest
import torch

from repro.core import NeighborSearch as JNS
from repro.core import SearchOpts as JOpts, SearchParams as JParams
import repro_torch.api as tapi
from repro_torch.convert import partition_plan_from_arrays
from repro_torch.core import (NeighborSearch, SearchOpts, SearchParams,
                              neighbor_search)
from repro_torch.kernels.ref import brute_force_search
from repro_torch.reliability import InjectedFault, faults

D2_ATOL = 1e-6
CPU = dict(device="cpu")


def _tuple(res):
    d2 = res.distances2.cpu().numpy()
    return (res.indices.cpu().numpy(), np.where(np.isinf(d2), -1.0, d2),
            res.counts.cpu().numpy())


def _assert_close_to_reference(jres, tres):
    jd2, td2 = np.asarray(jres.distances2), tres.distances2.numpy()
    jidx, tidx = np.asarray(jres.indices), tres.indices.numpy()
    np.testing.assert_array_equal(np.asarray(jres.counts),
                                  tres.counts.numpy())
    np.testing.assert_array_equal(np.isinf(jd2), np.isinf(td2))
    fin = np.isfinite(td2)
    np.testing.assert_allclose(td2[fin], jd2[fin], atol=D2_ATOL, rtol=0)
    for r, s in zip(*np.nonzero(tidx != jidx)):
        others = np.delete(td2[r], s)
        assert np.any(np.abs(others - td2[r, s]) <= D2_ATOL), (r, s)


def _astuples(xs):
    return [dataclasses.astuple(x) for x in xs]


def _groups(ns):
    """The launch groups of the executor's newest plan, as plain tuples."""
    _plan, _bundles, groups = list(ns.executor._plan_cache.values())[-1]
    return [(int(g.w_search), bool(g.skip_test), g.sel.tolist(),
             int(g.pad_n), int(g.n_bundles)) for g in groups]


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

MODES = {"knn": dict(radius=0.15, k=8, knn_window="exact"),
         "range": dict(radius=0.15, k=8, mode="range")}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    return (rng.random((600, 3)).astype(np.float32),
            rng.random((100, 3)).astype(np.float32))


@pytest.mark.parametrize("schedule,partition,bundle",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("mode", ["knn", "range"])
def test_query_matches_reference(scene, mode, pallas, schedule, partition,
                                 bundle):
    """``NeighborSearch.query`` over the ablation matrix (Fig. 13), on the
    plain path and on the fused kernel path: results within the stated
    tolerances, and the partitions, bundles and launch groups of the
    executor's plan exactly the reference's."""
    pts, qs = scene
    kw = dict(schedule=schedule, partition=partition, bundle=bundle,
              use_pallas=pallas, query_tile=64)
    jns = JNS(pts, JParams(**MODES[mode]), JOpts(**kw))
    tns = NeighborSearch(pts, SearchParams(**MODES[mode]), SearchOpts(**kw),
                         **CPU)
    _assert_close_to_reference(jns.query(qs), tns.query(qs))
    assert _astuples(jns.report.bundles) == _astuples(tns.report.bundles)
    assert jns.report.num_partitions == tns.report.num_partitions
    assert jns.report.launches == tns.report.launches
    jplan = list(jns.executor._plan_cache.values())[-1][0]
    tplan = list(tns.executor._plan_cache.values())[-1][0]
    np.testing.assert_array_equal(jplan.perm, tplan.perm)
    assert _astuples(jplan.partitions) == _astuples(tplan.partitions)
    assert _groups(jns) == _groups(tns)


@pytest.mark.parametrize("mode", ["knn", "range"])
def test_host_loop_matches_reference(scene, mode):
    """The legacy per-bundle host loop (``executor=False``) of both
    packages, and its transfer counts."""
    pts, qs = scene
    jns = JNS(pts, JParams(**MODES[mode]), JOpts(executor=False))
    tns = NeighborSearch(pts, SearchParams(**MODES[mode]),
                         SearchOpts(executor=False), **CPU)
    _assert_close_to_reference(jns.query(qs), tns.query(qs))
    for key in ("launches", "host_syncs", "plan_fetches", "num_partitions"):
        assert getattr(jns.report, key) == getattr(tns.report, key), key
    assert _astuples(jns.report.bundles) == _astuples(tns.report.bundles)


@pytest.mark.parametrize("mode,bundle", [("knn", True), ("range", False)])
def test_groups_from_the_reference_plan(scene, mode, bundle):
    """Fed the reference's partition plan (``convert``), the port bundles
    and groups it exactly as the reference does, independently of
    ``compute_megacells``."""
    pts, qs = scene
    opts = dict(bundle=bundle, query_tile=64)
    jns = JNS(pts, JParams(**MODES[mode]), JOpts(**opts))
    jns.query(qs)
    jplan, jbundles, jgroups = list(jns.executor._plan_cache.values())[-1]
    tns = NeighborSearch(pts, SearchParams(**MODES[mode]),
                         SearchOpts(**opts), **CPU)
    tplan = partition_plan_from_arrays(jplan.perm, jplan.partitions,
                                       w_full=jplan.w_full)
    tbundles = tns._bundle(tplan)
    assert _astuples(jbundles) == _astuples(tbundles)
    tgroups = tns.executor._build_groups(tplan, tbundles)
    assert len(tgroups) == len(jgroups)
    for jg, tg in zip(jgroups, tgroups):
        assert (jg.w_search, jg.skip_test, jg.pad_n, jg.n_bundles) == \
            (tg.w_search, tg.skip_test, tg.pad_n, tg.n_bundles)
        np.testing.assert_array_equal(jg.sel, tg.sel)


def test_one_shot_cache_reuses_searcher(rng):
    """Repeated one-shot ``neighbor_search`` over the same point set reuses
    ONE cached searcher (``tests/test_api.py``'s cache contract); the key
    holds the device."""
    params = SearchParams(radius=0.11, k=8, knn_window="exact")
    tapi.searcher_cache_clear()
    pts = rng.random((900, 3)).astype(np.float32)
    qs = rng.random((200, 3)).astype(np.float32)
    ns1 = tapi.cached_searcher(pts, params, **CPU)
    ns2 = tapi.cached_searcher(torch.from_numpy(pts), params, **CPU)
    assert ns1 is ns2
    assert tapi.searcher_cache_stats()["entries"] == 1
    res1 = neighbor_search(pts, qs, params.radius, params.k, **CPU)
    res2 = neighbor_search(pts, qs, params.radius, params.k, **CPU)
    assert tapi.searcher_cache_stats()["entries"] == 1
    np.testing.assert_array_equal(res1.indices.numpy(),
                                  res2.indices.numpy())
    other = rng.random((900, 3)).astype(np.float32)
    assert tapi.cached_searcher(other, params, **CPU) is not ns1
    assert tapi.searcher_cache_stats()["entries"] == 2
    tapi.searcher_cache_clear()
    assert tapi.searcher_cache_stats()["entries"] == 0


# ---------------------------------------------------------------------------
# the executor's contract (tests/test_executor.py, on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["knn", "range"])
@pytest.mark.parametrize("schedule,partition", list(
    itertools.product([False, True], repeat=2)))
def test_executor_identical_to_host_loop(rng, mode, schedule, partition):
    """The executor is a re-orchestration: same launches, same math, so its
    results equal the legacy per-bundle host loop's bitwise, padded-bucket
    edge rows included (397 is never a bucket multiple)."""
    pts = rng.random((1800, 3)).astype(np.float32)
    qs = rng.random((397, 3)).astype(np.float32)
    params = SearchParams(radius=0.11, k=8, mode=mode, knn_window="exact")
    kw = dict(schedule=schedule, partition=partition)
    res_old = NeighborSearch(pts, params, SearchOpts(executor=False, **kw),
                             **CPU).query(qs)
    res_new = NeighborSearch(pts, params, SearchOpts(executor=True, **kw),
                             **CPU).query(qs)
    for a, b in zip(_tuple(res_old), _tuple(res_new)):
        np.testing.assert_array_equal(a, b)


def test_executor_fused_range_group_padding_equals_host_loop():
    """On the fused path a group's bucket padding adds tiles that hold only
    copies of its last query, whose shared window differs from that
    query's own tile; in range mode that window can return another bounded
    subset (here it does: the setup is asserted). The executor scatters
    only the real rows, so it still equals the host loop bitwise. (The
    reference scatters the padded rows too and XLA keeps the last write,
    so on this scene its executor differs from its host loop in one row;
    ROADMAP queue 3.)"""
    from repro_torch.data.pointclouds import kitti_like_cloud
    pts = kitti_like_cloud(800, seed=1)
    params = SearchParams(radius=0.08, k=8, mode="range")
    kw = dict(use_pallas=True, query_tile=32)
    ns = NeighborSearch(pts, params, SearchOpts(**kw), **CPU)
    res_new = ns.query(pts)
    perm, _ = ns._schedule(ns.points)
    queries_s = ns.points[perm.long()]
    _plan, _bundles, groups = list(ns.executor._plan_cache.values())[-1]
    differs = False
    for g in groups:
        sel = np.pad(g.sel, (0, g.pad_n - len(g.sel)), mode="edge")
        idx, _d2, _cnt = ns._searcher()(
            ns.grid, ns.points, queries_s[torch.from_numpy(sel)], ns.spec,
            g.w_search, params.radius, params.k, g.skip_test, 32)
        differs |= not torch.equal(idx[len(g.sel) - 1], idx[-1])
    assert differs
    res_old = NeighborSearch(pts, params, SearchOpts(executor=False, **kw),
                             **CPU).query(pts)
    for a, b in zip(_tuple(res_old), _tuple(res_new)):
        np.testing.assert_array_equal(a, b)


def test_executor_matches_ref_oracle(rng):
    """End to end against the brute-force oracle: d2 and counts exact,
    every returned index verified by distance recomputation."""
    pts = rng.random((2200, 3)).astype(np.float32)
    qs = rng.random((500, 3)).astype(np.float32)
    r, k = 0.1, 8
    res = NeighborSearch(pts, SearchParams(radius=r, k=k,
                                           knn_window="exact"),
                         SearchOpts(), **CPU).query(qs)
    _oi, od, oc = brute_force_search(torch.from_numpy(pts),
                                     torch.from_numpy(qs), r, k)
    d_ref = np.where(np.isinf(od.numpy()), -1.0, od.numpy())
    d_got = _tuple(res)[1]
    np.testing.assert_allclose(d_got, d_ref, atol=D2_ATOL, rtol=0)
    np.testing.assert_array_equal(oc.numpy(), res.counts.numpy())
    ri = res.indices.numpy()
    valid = ri >= 0
    recompute = np.sum((qs[:, None] - pts[np.clip(ri, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(recompute[valid],
                               res.distances2.numpy()[valid], atol=1e-5)


def test_executor_fused_path_matches_plain_path(rng):
    pts = rng.random((1500, 3)).astype(np.float32)
    qs = rng.random((300, 3)).astype(np.float32)
    params = SearchParams(radius=0.1, k=8, knn_window="exact")
    res_j = NeighborSearch(pts, params, SearchOpts(), **CPU).query(qs)
    ns_p = NeighborSearch(pts, params,
                          SearchOpts(use_pallas=True, query_tile=128), **CPU)
    res_p = ns_p.query(qs)
    np.testing.assert_allclose(_tuple(res_j)[1], _tuple(res_p)[1],
                               atol=D2_ATOL, rtol=0)
    np.testing.assert_array_equal(res_j.counts.numpy(),
                                  res_p.counts.numpy())
    assert ns_p.executor.stats()["last"]["host_syncs"] == 1


def test_one_sync_contract(rng):
    """One blocking result wait per query; partitioning adds at most one
    plan-metadata fetch."""
    pts = rng.random((2000, 3)).astype(np.float32)
    qs = rng.random((400, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.09, k=8), SearchOpts(),
                        **CPU)
    ns.query(qs)
    last = ns.executor.stats()["last"]
    assert last["host_syncs"] == 1 and last["plan_fetches"] <= 1
    assert ns.report.host_syncs == 1
    ns2 = NeighborSearch(pts, SearchParams(radius=0.09, k=8),
                         SearchOpts(partition=False), **CPU)
    ns2.query(qs)
    last2 = ns2.executor.stats()["last"]
    assert last2["host_syncs"] == 1 and last2["plan_fetches"] == 0


def test_execute_async_overlap_matches_execute(rng):
    """Two batches dispatched before either is waited for return what the
    blocking path returns, each paying its own single wait."""
    pts = rng.random((1800, 3)).astype(np.float32)
    qa = rng.random((384, 3)).astype(np.float32)
    qb = rng.random((384, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.09, k=8), SearchOpts(),
                        **CPU)
    ref_a, ref_b = ns.query(qa), ns.query(qb)
    pa = ns.executor.execute_async(qa)
    pb = ns.executor.execute_async(qb)
    got_b = pb.wait()                       # out-of-order wait is fine
    got_a = pa.wait()
    for got, ref in ((got_a, ref_a), (got_b, ref_b)):
        for a, b in zip(_tuple(got), _tuple(ref)):
            np.testing.assert_array_equal(a, b)
    last = ns.executor.stats()["last"]
    assert last["host_syncs"] == 1
    assert last["plan_cache_hit"] and last["launcher_cache_hit"]
    assert pa.wait() is got_a               # idempotent
    assert pa.done() and pb.done()


def test_signature_batching_folds_bundles(rng):
    """Bundles sharing (w_search, skip_test) fold into one launch."""
    pts = np.concatenate([
        rng.random((3000, 3)) * 0.25,
        rng.random((300, 3)) * 0.75 + 0.25,
    ]).astype(np.float32)
    qs = pts[rng.integers(0, len(pts), 500)]
    ns = NeighborSearch(pts, SearchParams(radius=0.08, k=16, mode="range"),
                        SearchOpts(bundle=False), **CPU)
    ns.query(qs)
    sigs = {(b.w_search, b.skip_test) for b in ns.report.bundles}
    assert ns.report.launches == len(sigs) <= len(ns.report.bundles)


def test_second_query_zero_recompiles(rng):
    """A repeated same-shape query hits the plan cache and builds nothing;
    a query of new values may plan anew but builds nothing either."""
    pts = rng.random((2000, 3)).astype(np.float32)
    qs = rng.random((384, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=8), SearchOpts(),
                        **CPU)
    ns.executor.warmup(qs)
    built = ns.executor.stats()["jit_cache_sizes"]
    ns.query(qs)
    st = ns.executor.stats()
    assert st["last"]["compilations"] == 0 and st["last"]["plan_cache_hit"]
    assert st["jit_cache_sizes"] == built
    ns.query(rng.random((384, 3)).astype(np.float32))
    assert ns.executor.stats()["jit_cache_sizes"] == built


def test_drifting_queries_reuse_launcher(rng):
    """Query values drift step to step and partition counts shift within
    the same padded buckets: the launcher is reused."""
    pts = rng.random((2000, 3)).astype(np.float32)
    qs = rng.random((384, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=8), SearchOpts(),
                        **CPU)
    ns.executor.warmup(qs)
    for _ in range(3):
        qs = np.clip(qs + rng.normal(0, 0.002, qs.shape).astype(np.float32),
                     0, 1)
        ns.query(qs)
        st = ns.executor.stats()
        assert st["last"]["compilations"] == 0
        assert st["launcher_cache_entries"] == 1


def test_warmup_stats_surface(rng):
    pts = rng.random((1000, 3)).astype(np.float32)
    qs = rng.random((200, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=4), SearchOpts(),
                        **CPU)
    st = ns.executor.warmup(qs)
    assert st["queries"] == 1 and st["launches"] >= 1
    assert st["signatures"] >= 1
    assert st["jit_cache_sizes"] == {}      # the plain path builds nothing
    assert ns.report.t_search > 0
    fused = NeighborSearch(pts, SearchParams(radius=0.1, k=4),
                           SearchOpts(use_pallas=True), **CPU)
    # on CPU tensors the plain version runs: no library is loaded
    assert fused.executor.warmup(qs)["jit_cache_sizes"] == {
        "knn_tile_anchored": False}


def test_capture_plan_replay_matches_direct_query(rng):
    """A replayed margin-inflated plan matches a direct query exactly in
    knn mode, with zero host planning on replay."""
    pts = rng.random((1500, 3)).astype(np.float32)
    qs = rng.random((384, 3)).astype(np.float32)
    params = SearchParams(radius=0.1, k=8, knn_window="exact")
    ns = NeighborSearch(pts, params, SearchOpts(), **CPU)
    handle = ns.executor.capture_plan(qs, margin=1)
    res_r = ns.executor.execute(qs, reuse=handle)
    res_d = NeighborSearch(pts, params, SearchOpts(), **CPU).query(qs)
    np.testing.assert_array_equal(_tuple(res_r)[1], _tuple(res_d)[1])
    np.testing.assert_array_equal(res_r.counts.numpy(),
                                  res_d.counts.numpy())
    last = ns.executor.stats()["last"]
    assert last["plan_reused"] and last["plan_fetches"] == 0
    with pytest.raises(ValueError):
        ns.executor.execute(qs[:-1], reuse=handle)


def test_cache_hit_miss_accounting(rng):
    """Misses on first sight, hits on repeats, a fresh shape is a new miss,
    and invalidate() starts the count again from cold."""
    pts = rng.random((1500, 3)).astype(np.float32)
    qs = rng.random((384, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=8), SearchOpts(),
                        **CPU)
    ex = ns.executor
    ns.query(qs)
    st = ex.stats()
    assert st["plan_cache_misses"] == 1 and st["plan_cache_hits"] == 0
    assert st["launcher_cache_misses"] == 1
    assert st["launcher_cache_hits"] == 0
    ns.query(qs)
    st = ex.stats()
    assert st["plan_cache_hits"] == 1 and st["plan_cache_misses"] == 1
    assert st["launcher_cache_hits"] == 1
    assert st["launcher_cache_misses"] == 1
    assert st["last"]["plan_cache_hit"] and st["last"]["launcher_cache_hit"]
    ns.query(rng.random((512, 3)).astype(np.float32))
    st = ex.stats()
    assert st["plan_cache_misses"] == 2
    assert st["launcher_cache_misses"] == 2
    assert not st["last"]["plan_cache_hit"]
    ex.invalidate()
    st = ex.stats()
    assert st["invalidations"] == 1
    assert st["plan_cache_entries"] == 0 and st["launcher_cache_entries"] == 0
    ns.query(qs)
    st = ex.stats()
    assert st["plan_cache_misses"] == 3 and not st["last"]["plan_cache_hit"]


def test_warmup_yields_zero_compile_misses(rng):
    pts = rng.random((1200, 3)).astype(np.float32)
    qs = rng.random((256, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=8), SearchOpts(),
                        **CPU)
    ns.executor.warmup(qs)
    before = ns.executor.stats()["launcher_cache_misses"]
    ns.query(qs)
    st = ns.executor.stats()
    assert st["launcher_cache_misses"] == before
    assert st["last"]["compilations"] == 0 and st["last"]["plan_cache_hit"]


def test_fault_seams(rng):
    """The executor's fault-injection seams: a launch fault fails the
    dispatch, a compile fault fails a launcher-cache miss only, a
    straggler delays the wait; each once (budget 1), then queries run."""
    pts = rng.random((800, 3)).astype(np.float32)
    qs = rng.random((128, 3)).astype(np.float32)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=4), SearchOpts(),
                        **CPU)
    with faults.scoped(faults.FaultPlan(launch=1.0, budgets={"launch": 1})):
        with pytest.raises(InjectedFault) as info:
            ns.query(qs)
        assert info.value.kind == "launch"
        ns.query(qs)
    ns = NeighborSearch(pts, SearchParams(radius=0.1, k=4), SearchOpts(),
                        **CPU)
    with faults.scoped(faults.FaultPlan(compile=1.0,
                                        budgets={"compile": 1})):
        with pytest.raises(InjectedFault):
            ns.query(qs)
        ns.query(qs)
        ns.query(qs)                        # launcher cached: no decision
        assert faults.active().stats()["decisions"]["compile"] == 2
    plan = faults.FaultPlan(straggler=1.0, delay_s=0.0, budgets={
        "straggler": 1})
    with faults.scoped(plan):
        ns.query(qs)
        assert plan.stats()["fired"]["straggler"] == 1
    assert faults.active() is None


def test_fault_plan_parse_matches_reference():
    from repro.reliability import faults as jfaults
    spec = "launch:0.2,straggler:0.1,poison:0.05,seed:7,delay_ms:3,budget:2"
    jp, tp = jfaults.FaultPlan.parse(spec), faults.FaultPlan.parse(spec)
    assert (jp.rates, jp.seed, jp.delay_s, jp.budgets) == \
        (tp.rates, tp.seed, tp.delay_s, tp.budgets)
    # the same seeded decisions at every site
    for site in ("launch", "straggler", "poison"):
        assert [jp.decide(site) for _ in range(50)] == \
            [tp.decide(site) for _ in range(50)]
    q = np.zeros((4, 3), np.float32)
    with faults.scoped(faults.FaultPlan(poison=1.0, seed=1)):
        out = faults.maybe_poison(q)
    assert np.isnan(out).any() and not np.isnan(q).any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["knn", "range"])
def test_host_planned_on_card(rng, mode):
    """On the card: the result equals the port's CPU result, a query makes
    exactly two blocking transfers (the plan fetch and the result wait),
    and a repeat builds nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    pts = rng.random((20000, 3)).astype(np.float32)
    qs = rng.random((3000, 3)).astype(np.float32)
    params = SearchParams(**MODES[mode])
    opts = SearchOpts(use_pallas=True)
    ns = NeighborSearch(pts, params, opts)
    q = torch.from_numpy(qs).cuda()
    ns.executor.warmup(q)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = ns.query(q)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 2, [str(w.message) for w in syncs]
    st = ns.executor.stats()
    assert st["last"]["compilations"] == 0
    assert st["jit_cache_sizes"] == {"knn_tile_anchored": True}
    cpu = NeighborSearch(pts, params, opts, **CPU).query(qs)
    for a, b in zip(_tuple(cpu), _tuple(res)):
        np.testing.assert_array_equal(a, b)
