"""The port's sharded scenes (``repro_torch.core.shards``,
``core/distributed.py``, ``launch/mesh.py``) vs the JAX reference.

In process, with no mesh: ``plan_layout`` field by field, the routing
scatters exactly (``tests/test_shards.py``'s inputs, overflow included),
the halo exchange and migration against a plain numpy model of the
neighbor shift, and the 1-slab ``shard_scene`` / ``ShardedSession``
against the reference on its one CPU device.

Multi-slab: the reference runs in ONE subprocess under 8 forced host
devices (``tests/test_multidevice.py``'s setting) on inputs written here
with numpy, and the port runs the same inputs in process, its slabs
sharing the CPU. Layouts, routed buffers, resident ids, per-step flags and
``stats()`` must be equal; results as in ``test_torch_dynamic.py``: counts
and inf masks exact, ``d2`` within atol 1e-6, indices equal except
between distances that tie within 1e-6. Two allowances: a row may differ
by a candidate whose ``d2`` lies within 1e-6 of ``r^2``, where the two
packages' last-bit ``d2`` rounding puts it on either side of the radius
(each side must then equal its own package's brute force there); and on
a frame moved out of the unit box the 1e-6 scales with the square of its
largest coordinate.

Then the reference's contract tests on the port at 4 slabs, and two
``cuda`` tests that run only on the card.
"""
import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import shards as js
import repro_torch.core as tc
from repro_torch.core import shards as ts
from repro_torch.core.distributed import distributed_neighbor_search
from repro_torch.kernels.ref import brute_force_search
from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh

from _shard_cases import (D2_ATOL, PARAMS_KNN, reference_results,
                          start_reference)
from _shard_cases import assert_same_result as _assert_same_result
from _shard_cases import dist_cases as _dist_cases
from _shard_cases import layout_dict as _layout
from _shard_cases import r2 as _r2
from _shard_cases import session_cases as _session_cases
from _shard_cases import t as _t

PARAMS = dict(radius=0.12, k=8, knn_window="exact")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_layout(jl, tl):
    assert json.loads(json.dumps(_layout(jl))) == _layout(tl)


def _assert_oracle(res, pts, qs, radius, k, mode="knn"):
    """Counts equal the port's brute force; every index reproduces its
    distance within the radius; knn distances equal the oracle's."""
    _oi, od, oc = brute_force_search(_t(pts), _t(qs), radius, k)
    np.testing.assert_array_equal(oc.numpy(), res.counts.numpy())
    rd, ri = res.distances2.numpy(), res.indices.numpy()
    if mode == "knn":
        np.testing.assert_allclose(np.where(np.isinf(rd), -1, rd),
                                   np.where(np.isinf(od.numpy()), -1,
                                            od.numpy()), atol=1e-5)
    valid = ri >= 0
    assert (rd[valid] <= np.float32(radius) ** 2 + 1e-6).all()
    rec = np.sum((qs[:, None] - pts[np.clip(ri, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(rec[valid], rd[valid], atol=1e-5)


# ---------------------------------------------------------------------------
# multi-slab reference results: one subprocess, 8 forced host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every multi-slab reference result, from one subprocess under 8
    forced host devices."""
    tmp = tmp_path_factory.mktemp("shards_ref")
    return reference_results(start_reference(tmp), tmp)


@pytest.mark.parametrize("name", list(_dist_cases()))
def test_distributed_search_matches_reference(reference, name):
    """``distributed_neighbor_search`` on a (4, 2) mesh: the same results,
    layout, routed point buffers and query routing as the reference's
    (whose routing is also the same under ``jit``: the face queries route
    identically), and oracle-exact."""
    pts, qs, kw = _dist_cases()[name]
    ref = {k.split("/", 1)[1]: v for k, v in reference.items()
           if k.startswith(name + "/")}
    mesh = make_mesh_compat((4, 2), ("data", "model"), device="cpu")
    params = tc.SearchParams(**kw)
    res = distributed_neighbor_search(mesh, pts, qs, params)
    _assert_same_result(ref["oi"], ref["od"], ref["oc"], res, pts, qs,
                        _r2(kw))
    _assert_oracle(res, pts, qs, kw["radius"], kw["k"], params.mode)

    if params.mode == "knn":
        params = dataclasses.replace(params, knn_window="exact")
    index = tc.shard_scene(pts, params, mesh=mesh,
                           shopts=ts.STATIC_SCENE_OPTS, queries=qs,
                           query_axis="model")
    assert json.loads(str(ref["layout"])) == _layout(index.layout)
    np.testing.assert_array_equal(index.pts.numpy(), ref["spts"])
    np.testing.assert_array_equal(index.ids.numpy(), ref["sids"])
    rq, qid, qovf = ts.route_queries(index.layout, _t(qs))
    np.testing.assert_array_equal(rq.numpy(), ref["rq"])
    np.testing.assert_array_equal(qid.numpy(), ref["qid"])
    np.testing.assert_array_equal(ref["qid_jit"], ref["qid"])
    assert int(qovf) == int(ref["qovf"]) == 0


@pytest.mark.parametrize("name", list(_session_cases()))
def test_sharded_session_matches_reference(reference, name):
    """Step by step: results, resident ids (routing, migration and the
    free-row merge), last flags and the whole ``stats()`` (steps,
    fast_steps, replans, reroutes, host_routings, host_syncs, migrated,
    migrated_rows, halo_rows, level occupancy, boost) equal the
    reference's; every frame oracle-exact."""
    frames, c = _session_cases()[name]
    params = tc.SearchParams(**c["params"])
    sess = tc.ShardedSession(frames[0], params, n_slabs=c["n_slabs"],
                             shopts=ts.ShardOpts(**c.get("shopts", {})),
                             device="cpu")
    for f, frame in enumerate(frames):
        res = sess.step(frame)
        pre = f"{name}/{f}/"
        _assert_same_result(reference[pre + "oi"], reference[pre + "od"],
                            reference[pre + "oc"], res, frame, frame,
                            _r2(c["params"]))
        _assert_oracle(res, frame, frame, params.radius, params.k,
                       params.mode)
        np.testing.assert_array_equal(sess._ids.numpy(),
                                      reference[pre + "ids"])
        st = {k: v for k, v in sess.stats().items() if k != "t_step"}
        assert st == json.loads(str(reference[pre + "stats"])), f
        assert _layout(sess.layout) == json.loads(str(
            reference[pre + "layout"]))
    st = sess.stats()
    if name == "reroute_range":
        assert st["reroutes"] == 1 and st["host_routings"] == 2
    if name == "drift":
        assert st["migrated"] > 0 and st["host_routings"] == 1


# ---------------------------------------------------------------------------
# in process, no mesh: layout, routing, halo, migration
# ---------------------------------------------------------------------------

LAYOUT_CASES = {
    "default_4": dict(n=900, n_slabs=4, kw={}),
    "static_4": dict(n=900, n_slabs=4, kw=dict(shopts="static")),
    "qsplit_3x2": dict(n=500, n_slabs=3, kw=dict(n_qsplit=2, queries=123)),
    "boost_2": dict(n=900, n_slabs=4, kw=dict(boost=2.0)),
    "cell_size": dict(n=700, n_slabs=2, kw=dict(cell_size=0.05)),
    "one_slab": dict(n=300, n_slabs=1, kw={}),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_plan_layout_matches_reference(case):
    c = LAYOUT_CASES[case]
    rng = np.random.default_rng(len(case))
    pts = rng.random((c["n"], 3)).astype(np.float32)
    jkw, tkw = dict(c["kw"]), dict(c["kw"])
    if "queries" in jkw:
        jkw["queries"] = tkw["queries"] = rng.random(
            (jkw["queries"], 3)).astype(np.float32)
    if jkw.get("shopts") == "static":
        jkw["shopts"], tkw["shopts"] = js.STATIC_SCENE_OPTS, \
            ts.STATIC_SCENE_OPTS
    jl = js.plan_layout(pts, jc.SearchParams(**PARAMS), c["n_slabs"], **jkw)
    tl = ts.plan_layout(pts, tc.SearchParams(**PARAMS), c["n_slabs"], **tkw)
    _same_layout(jl, tl)
    assert tl.total_rows == jl.total_rows


def test_shard_opts_match_reference():
    assert dataclasses.asdict(ts.ShardOpts()) == dataclasses.asdict(
        js.ShardOpts())
    assert dataclasses.asdict(ts.STATIC_SCENE_OPTS) == dataclasses.asdict(
        js.STATIC_SCENE_OPTS)


def _both_layouts(pts, n_slabs, **kw):
    return (js.plan_layout(pts, jc.SearchParams(**PARAMS), n_slabs, **kw),
            ts.plan_layout(pts, tc.SearchParams(**PARAMS), n_slabs, **kw))


@pytest.mark.parametrize("tight", [False, True])
def test_route_points_matches_reference(rng, tight):
    """``tests/test_shards.py``'s roundtrip (700 points, 4 slabs) and its
    overflow case (300 points, 2 slabs, point_cap 100): buffers, ids and
    the dropped count exactly."""
    n, n_slabs = (300, 2) if tight else (700, 4)
    pts = rng.random((n, 3)).astype(np.float32)
    jl, tl = _both_layouts(pts, n_slabs)
    if tight:
        jl = dataclasses.replace(jl, point_cap=100)
        tl = dataclasses.replace(tl, point_cap=100)
    jp, ji, jo = js.route_points(jl, jnp.asarray(pts))
    tp, ti, to = ts.route_points(tl, _t(pts))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert int(jo) == int(to) and (int(to) > 0) == tight
    with pytest.raises(RuntimeError, match="overflowed") if tight else \
            contextlib.nullcontext():
        ts._check_routable(tl, pts)


@pytest.mark.parametrize("query_cap", [None, 10])
def test_route_queries_and_unroute_match_reference(rng, query_cap):
    """Queries split round-robin over the qsplit columns and back through
    ``unroute_results``, exactly as the reference's, with a query cap that
    drops rows too."""
    pts = rng.random((500, 3)).astype(np.float32)
    qs = rng.random((123, 3)).astype(np.float32)
    jl, tl = _both_layouts(pts, 3, n_qsplit=2, queries=qs)
    if query_cap:
        jl = dataclasses.replace(jl, query_cap=query_cap)
        tl = dataclasses.replace(tl, query_cap=query_cap)
    jq, jqid, jo = js.route_queries(jl, jnp.asarray(qs))
    tq, tqid, to = ts.route_queries(tl, _t(qs))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(jqid), tqid.numpy())
    assert int(jo) == int(to) and (int(to) > 0) == bool(query_cap)
    k = 4
    gidx = rng.integers(-1, 500, tqid.shape + (k,)).astype(np.int32)
    d2 = np.where(gidx >= 0, rng.random(gidx.shape), np.inf).astype(
        np.float32)
    cnt = (gidx >= 0).sum(-1).astype(np.int32)
    want = js.unroute_results(jqid, jnp.asarray(gidx), jnp.asarray(d2),
                              jnp.asarray(cnt), 123)
    got = ts.unroute_results(tqid, _t(gidx), _t(d2), _t(cnt), 123)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _np_slab(layout, x):
    return np.clip(np.floor((x - np.float32(layout.lo_x))
                            / np.float32(layout.slab_width)),
                   0, layout.n_slabs - 1).astype(np.int64)


def _np_first(mask, cap):
    rows = np.nonzero(mask)[0]
    return rows[:cap], len(rows)


def _np_with_halo(layout, pts, ids):
    """Plain model: slab s receives the first ``halo_cap`` rows of slab
    s-1 within ``halo`` of their shared face, then those of slab s+1."""
    s_n, h = layout.n_slabs, layout.halo_cap
    f32 = np.float32
    send_l, send_r, ovf = [], [], []
    for s in range(s_n):
        lo = f32(layout.lo_x) + f32(s) * f32(layout.slab_width)
        hi = lo + f32(layout.slab_width)
        x, valid = pts[s, :, 0], ids[s] >= 0
        rl, nl = _np_first(valid & (x - lo <= f32(layout.halo)) & (s > 0), h)
        rr, nr = _np_first(valid & (hi - x <= f32(layout.halo))
                           & (s < s_n - 1), h)
        send_l.append(rl)
        send_r.append(rr)
        ovf.append(max(nl - h, 0) + max(nr - h, 0))
    all_p, all_i = [], []
    for s in range(s_n):
        hp = np.full((2 * h, 3), 1e30, np.float32)
        hi_ = np.full((2 * h,), -1, np.int32)
        if s > 0:
            r = send_r[s - 1]
            hp[:len(r)], hi_[:len(r)] = pts[s - 1, r], ids[s - 1, r]
        if s < s_n - 1:
            r = send_l[s + 1]
            hp[h:h + len(r)], hi_[h:h + len(r)] = pts[s + 1, r], ids[s + 1, r]
        all_p.append(np.concatenate([pts[s], hp]))
        all_i.append(np.concatenate([ids[s], hi_]))
    return np.stack(all_p), np.stack(all_i), np.array(ovf)


def _np_migrate(layout, pts, ids):
    """Plain model: movers leave their rows; slab s takes slab s-1's
    first ``migrate_cap`` right-movers, then slab s+1's left-movers, in
    that order, into its free rows in row order."""
    s_n, m = layout.n_slabs, layout.migrate_cap
    pts, ids = pts.copy(), ids.copy()
    sends, ovf, n_mig = [], [], []
    for s in range(s_n):
        valid = ids[s] >= 0
        delta = np.where(valid, _np_slab(layout, pts[s, :, 0]) - s, 0)
        rl, nl = _np_first(delta < 0, m)
        rr, nr = _np_first(delta > 0, m)
        sends.append(((pts[s, rl].copy(), ids[s, rl].copy()),
                      (pts[s, rr].copy(), ids[s, rr].copy())))
        ovf.append(max(nl - m, 0) + max(nr - m, 0)
                   + int((np.abs(delta) > 1).sum()))
        n_mig.append(nl + nr)
        gone = delta != 0
        pts[s, gone], ids[s, gone] = 1e30, -1
    for s in range(s_n):
        arrivals = []
        if s > 0:
            arrivals += list(zip(*sends[s - 1][1]))
        if s < s_n - 1:
            arrivals += list(zip(*sends[s + 1][0]))
        free = np.nonzero(ids[s] < 0)[0]
        for (p, i), row in zip(arrivals, free):
            pts[s, row], ids[s, row] = p, i
        ovf[s] += max(len(arrivals) - len(free), 0)
    return pts, ids, np.array(n_mig), np.array(ovf)


def _routed(rng, n, n_slabs, **kw):
    pts = rng.random((n, 3)).astype(np.float32)
    layout = ts.plan_layout(pts, tc.SearchParams(**PARAMS), n_slabs, **kw)
    p, i, _ = ts.route_points(layout, _t(pts))
    return layout, p, i


@pytest.mark.parametrize("halo_cap", [None, 5])
def test_with_halo_matches_numpy_model(rng, halo_cap):
    """The shift along the slab axis against a per-slab numpy model, with
    the planned cap and with a cap so small that faces overflow."""
    layout, p, i = _routed(rng, 900, 4)
    if halo_cap:
        layout = dataclasses.replace(layout, halo_cap=halo_cap)
    ap, ai, ovf = ts._with_halo(layout, p, i)
    wp, wi, wovf = _np_with_halo(layout, p.numpy(), i.numpy())
    np.testing.assert_array_equal(ap.numpy(), wp)
    np.testing.assert_array_equal(ai.numpy(), wi)
    np.testing.assert_array_equal(ovf.numpy(), wovf)
    assert (wovf > 0).any() == bool(halo_cap)
    assert ap.shape[1] == layout.total_rows


@pytest.mark.parametrize("case", ["drift", "far_hop", "tight_cap",
                                  "no_free_rows"])
def test_migrate_matches_numpy_model(rng, case):
    """Migration against the numpy model: a drift across faces, a row that
    hops two slabs, a migration cap that overflows, and a slab with fewer
    free rows than arrivals (the arrival-rank merge of
    ``tests/test_multidevice.py:182``)."""
    layout, p, i = _routed(rng, 900, 4)
    moved = p.clone()
    valid = i >= 0
    step = torch.from_numpy(rng.normal(0, 0.03, p.shape).astype(np.float32))
    moved = torch.where(valid[..., None], moved + step, moved)
    if case == "far_hop":
        moved[0, 0, 0] += 0.6
    if case == "tight_cap":
        layout = dataclasses.replace(layout, migrate_cap=2)
    if case == "no_free_rows":
        layout = dataclasses.replace(layout, point_cap=p.shape[1])
        full = torch.nonzero(i[1] < 0).flatten()
        i = i.clone()
        i[1, full] = 10_000 + torch.arange(full.numel(), dtype=torch.int32)
        moved[1, full] = 0.3
    got = ts._migrate(layout, moved, i)
    want = _np_migrate(layout, moved.numpy(), i.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[3] > 0).any() == (case != "drift")
    assert want[2].sum() > 0


def test_migration_into_nearly_full_slab_keeps_free_rows(rng):
    """``tests/test_multidevice.py:182``: an arrival from the RIGHT
    neighbor into a slab with fewer free rows than ``migrate_cap`` merges
    without tripping the exhausted flag."""
    pts = rng.random((200, 3)).astype(np.float32)
    pts[:96, 0] = pts[:96, 0] * 0.5
    pts[96:, 0] = 0.5 + pts[96:, 0] * 0.5
    sess = tc.ShardedSession(pts, tc.SearchParams(radius=0.05, k=4,
                                                  knn_window="exact"),
                             n_slabs=2, device="cpu",
                             shopts=ts.ShardOpts(point_slack=1.0,
                                                 domain_margin_radii=2.0))
    assert sess.layout.point_cap == 104
    assert sess.layout.migrate_cap > 104 - 96
    sess.step(pts)
    moved = pts.copy()
    moved[100, 0] = 0.49
    res = sess.step(moved)
    st = sess.stats()
    assert st["migrated"] >= 1
    assert st["reroutes"] == 0 and st["host_routings"] == 1
    _assert_oracle(res, moved, moved, 0.05, 4)


# ---------------------------------------------------------------------------
# 1 slab: the reference on its one CPU device, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [False, True])
def test_shard_scene_one_slab_matches_reference(rng, pallas):
    """``tests/test_shards.py:95`` and its ``use_pallas`` case (:113,
    the reference's Pallas kernel in interpret mode, the port's plain
    version of its kernel): the same results, oracle-exact."""
    n, nq, radius = (400, 100, 0.15) if pallas else (600, 150, 0.12)
    pts = rng.random((n, 3)).astype(np.float32)
    qs = rng.random((nq, 3)).astype(np.float32)
    kw = dict(radius=radius, k=8, knn_window="exact")
    okw = dict(use_pallas=pallas, query_tile=128)
    jres = js.shard_scene(pts, jc.SearchParams(**kw), n_slabs=1,
                          opts=jc.SearchOpts(**okw), queries=qs).query(qs)
    index = tc.shard_scene(pts, tc.SearchParams(**kw), n_slabs=1,
                           opts=tc.SearchOpts(**okw), queries=qs,
                           device="cpu")
    res = index.query(qs)
    _assert_same_result(np.asarray(jres.indices),
                        np.asarray(jres.distances2), np.asarray(jres.counts),
                        res, pts, qs, _r2(kw))
    _assert_oracle(res, pts, qs, radius, 8)


def test_sharded_session_one_slab_matches_reference(rng):
    """``tests/test_shards.py:133``: five drifting steps on a 1-slab mesh,
    step by step equal to the reference's sharded session (results,
    flags, ``stats()``), then a mass escape that re-routes once (:160)."""
    pts = rng.random((500, 3)).astype(np.float32)
    jsess = js.ShardedSession(pts, jc.SearchParams(**PARAMS), n_slabs=1)
    tsess = tc.ShardedSession(pts, tc.SearchParams(**PARAMS), n_slabs=1,
                              device="cpu")
    frames = []
    for _ in range(5):
        frames.append(pts)
        pts = np.clip(pts + rng.normal(0, 0.0006, pts.shape),
                      0.0, 1.0).astype(np.float32)
    far = (pts + np.float32([3.0, 0.0, 0.0])).astype(np.float32)
    frames += [far, far]
    for f in frames:
        jres, tres = jsess.step(f), tsess.step(f)
        _assert_same_result(np.asarray(jres.indices),
                            np.asarray(jres.distances2),
                            np.asarray(jres.counts), tres, f, f,
                            _r2(PARAMS))
        _assert_oracle(tres, f, f, PARAMS["radius"], PARAMS["k"])
        jst, tst = jsess.stats(), tsess.stats()
        del jst["t_step"], tst["t_step"]
        assert jst == tst
    assert tst["reroutes"] == 1 and tst["host_routings"] == 2
    assert tst["fast_steps"] >= 1


# ---------------------------------------------------------------------------
# the reference's contracts on the port, 4 slabs in process
# ---------------------------------------------------------------------------

def test_sharded_session_steady_state_replays(rng):
    """``tests/test_multidevice.py:154``: y/z-only drift replays every
    slab's plan: fast steps, no host routing, nothing migrates, one
    transfer a step."""
    pts = rng.random((900, 3)).astype(np.float32)
    sess = tc.ShardedSession(pts, tc.SearchParams(**PARAMS), n_slabs=4,
                             device="cpu")
    sess.step(pts)
    drift = np.zeros_like(pts)
    for _ in range(4):
        drift[:, 1:] = rng.normal(0, 0.0002, (900, 2))
        pts = np.clip(pts + drift, 0.0, 1.0).astype(np.float32)
        res = sess.step(pts)
    _assert_oracle(res, pts, pts, PARAMS["radius"], PARAMS["k"])
    st = sess.stats()
    assert st["fast_steps"] >= 3 and st["host_routings"] == 1
    assert st["migrated"] == 0 and st["host_syncs"] == st["steps"] == 5


def test_sharded_session_reroute_disabled_raises(rng):
    pts = rng.random((200, 3)).astype(np.float32)
    sess = tc.ShardedSession(pts, tc.SearchParams(**PARAMS), n_slabs=4,
                             shopts=ts.ShardOpts(auto_reroute=False),
                             device="cpu")
    sess.step(pts)
    with pytest.raises(RuntimeError, match="exhausted"):
        sess.step(pts + np.float32([5.0, 0, 0]))


def test_sharded_session_particle_count_change_reroutes(rng):
    """A frame with another number of particles re-plans the layout on
    the host (the caps are static) and stays oracle-exact."""
    pts = rng.random((400, 3)).astype(np.float32)
    sess = tc.ShardedSession(pts, tc.SearchParams(**PARAMS), n_slabs=4,
                             device="cpu")
    sess.step(pts)
    more = rng.random((520, 3)).astype(np.float32)
    res = sess.step(more)
    _assert_oracle(res, more, more, PARAMS["radius"], PARAMS["k"])
    st = sess.stats()
    assert st["host_routings"] == 2 and st["reroutes"] == 0


def test_query_cap_overflow_raises(rng):
    """A query batch denser than the planned cap fails with the re-plan
    hint instead of dropping queries."""
    pts = rng.random((400, 3)).astype(np.float32)
    few = rng.random((10, 3)).astype(np.float32)
    index = tc.shard_scene(pts, tc.SearchParams(**PARAMS), n_slabs=4,
                           queries=few, shopts=ts.STATIC_SCENE_OPTS,
                           device="cpu")
    with pytest.raises(RuntimeError, match="query_cap"):
        index.query(rng.random((200, 3)).astype(np.float32))


def test_slab_mesh_shapes():
    """``mesh.shape[axis]`` as JAX's; more slabs than devices share the
    device; one slab per device by default."""
    mesh = make_mesh_compat((4, 2), ("data", "model"), device="cpu")
    assert mesh.shape["data"] == 4 and mesh.shape["model"] == 2
    assert mesh.device == torch.device("cpu")
    assert make_slab_mesh(device="cpu").shape == {"data": 1}
    assert make_slab_mesh(6, axis="x", device="cpu").shape == {"x": 6}
    with pytest.raises(ValueError):
        make_mesh_compat((4,), ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
def test_sharded_session_on_card_fused_equals_plain():
    """The 4-slab drift with ``use_pallas=True`` (``knn_tile_anchored`` and
    ``bin_disp_tile`` on slab inputs: shifted origins, parked rows) against
    the plain path on the same card: identical resident ids, flags and
    counters, results within the module's tolerance, oracle-exact."""
    _need_card()
    frames, c = _session_cases()["drift"]
    params = tc.SearchParams(**c["params"])
    fused = tc.ShardedSession(frames[0], params,
                              tc.SearchOpts(use_pallas=True), n_slabs=4)
    plain = tc.ShardedSession(frames[0], params, n_slabs=4)
    for frame in frames:
        cur = torch.from_numpy(frame).cuda()
        rf, rp = fused.step(cur), plain.step(cur)
        torch.cuda.synchronize()
        assert torch.equal(fused._ids, plain._ids)
        assert fused.last_flags == plain.last_flags
        np.testing.assert_array_equal(rf.counts.cpu().numpy(),
                                      rp.counts.cpu().numpy())
        np.testing.assert_allclose(rf.distances2.cpu().numpy(),
                                   rp.distances2.cpu().numpy(),
                                   atol=D2_ATOL, rtol=0)
        _assert_oracle(tc.SearchResult(rf.indices.cpu(),
                                       rf.distances2.cpu(),
                                       rf.counts.cpu()),
                       frame, frame, params.radius, params.k)
    sf, sp = fused.stats(), plain.stats()
    for k in ("steps", "fast_steps", "replans", "migrated", "halo_rows"):
        assert sf[k] == sp[k], k


@pytest.mark.cuda
def test_sharded_session_on_card_one_transfer_per_step():
    """One blocking transfer a step on the card (two on the re-route
    step), counted by ``torch.cuda.set_sync_debug_mode``, and S launches
    of each kernel a step."""
    _need_card()
    import warnings
    from repro_torch.kernels import knn_tile as tknn
    from repro_torch.kernels import update_tile as tup
    frames, _c = _session_cases()["reroute_range"]
    sess = tc.ShardedSession(frames[0], tc.SearchParams(**PARAMS_KNN),
                             tc.SearchOpts(use_pallas=True), n_slabs=4)
    for frame in frames:
        cur = torch.from_numpy(frame).cuda()
        torch.cuda.synchronize()
        b0, k0 = tup.bin_disp_tile.launches, tknn.knn_tile_anchored.launches
        r0 = sess.stats()["reroutes"]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = sess.step(cur)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rerouted = sess.stats()["reroutes"] - r0
        syncs = [w for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        assert len(syncs) == 1 + rerouted, [str(w.message) for w in syncs]
        assert tup.bin_disp_tile.launches == b0 + 4
        assert tknn.knn_tile_anchored.launches == k0 + 4
        torch.cuda.synchronize()
        _assert_oracle(tc.SearchResult(res.indices.cpu(),
                                       res.distances2.cpu(),
                                       res.counts.cpu()),
                       frame, frame, 0.1, 8)
    assert sess.stats()["reroutes"] == 1
