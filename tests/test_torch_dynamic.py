"""The port's ``SimulationSession`` vs the JAX reference, step by step, and
the reference's session contract tests (``tests/test_dynamic.py``) on the
port.

Parity: the same trajectories, made with numpy, go through both sessions;
each step must take the same branch (``fast`` / ``replanned`` /
``respecced``) with the same counters, and ``stats()`` must hold the same
lifecycle counters. Results: counts and inf masks exact, ``d2`` within
atol 1e-6 (the rule of ``test_torch_api.py``), indices equal except
between distances that tie within 1e-6.

The reference's ``test_session_retrace_contract_across_replans_and_respec``
has no counterpart: it counts ``jit`` variants of the fused step, and the
port runs eagerly with no compiled step to retrace (``step_cache_size`` is
left out of the port's ``stats()`` for the same reason). Its exactness
checks across replans and a respec are covered below.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.convert import session_from_arrays
from repro_torch.core.dynamic import validate_session_opts
from repro_torch.kernels import update_tile as tup
from repro_torch.kernels.ref import brute_force_search

D2_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drift(rng, pts, sigma):
    return np.clip(pts + rng.normal(0, sigma, pts.shape), 0.0,
                   1.0).astype(np.float32)


def _assert_oracle_exact(res, pts, qs, radius, k, mode="knn"):
    """Counts exact and every returned index verified by distance
    recomputation; in knn mode the distances equal the oracle's too."""
    _oi, od, oc = brute_force_search(torch.as_tensor(pts),
                                     torch.as_tensor(qs), radius, k)
    np.testing.assert_array_equal(oc.numpy(), res.counts.numpy())
    rd, ri = res.distances2.numpy(), res.indices.numpy()
    if mode == "knn":
        d_ref = np.where(np.isinf(od.numpy()), -1.0, od.numpy())
        d_got = np.where(np.isinf(rd), -1.0, rd)
        np.testing.assert_allclose(d_got, d_ref, atol=1e-5)
    valid = ri >= 0
    assert (rd[valid] <= radius * radius + 1e-6).all()
    recompute = np.sum((np.asarray(qs)[:, None]
                        - np.asarray(pts)[np.clip(ri, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(recompute[valid], rd[valid], atol=1e-5)


def _assert_same_result(jres, tres):
    ri, rd, rc = (np.asarray(jres.indices), np.asarray(jres.distances2),
                  np.asarray(jres.counts))
    gi, gd, gc = (tres.indices.numpy(), tres.distances2.numpy(),
                  tres.counts.numpy())
    np.testing.assert_array_equal(rc, gc)
    np.testing.assert_array_equal(np.isinf(rd), np.isinf(gd))
    fin = np.isfinite(gd)
    np.testing.assert_allclose(gd[fin], rd[fin], atol=D2_ATOL, rtol=0)
    for r, s in zip(*np.nonzero(gi != ri)):
        others = np.delete(gd[r], s)
        assert np.any(np.abs(others - gd[r, s]) <= D2_ATOL), (r, s)


def _assert_same_step(jsess, tsess):
    jr, tr = jsess.report, tsess.report
    for name in ("fast", "replanned", "respecced", "overflow", "oob",
                 "max_disp"):
        assert getattr(jr, name) == getattr(tr, name), name


def _counters(stats):
    return {k: v for k, v in stats.items()
            if k not in ("last", "step_cache_size")}


def _pair(pts, params, opts, sopts=None):
    """A reference session and a port session (CPU) on the same points."""
    jp = jc.SearchParams(**params)
    jo = jc.SearchOpts(**opts)
    jso = jc.SessionOpts(**(sopts or {}))
    tp = tc.SearchParams(**params)
    to = tc.SearchOpts(**opts)
    tso = tc.SessionOpts(**(sopts or {}))
    return (jc.SimulationSession(pts, jp, jo, jso),
            tc.SimulationSession(pts, tp, to, tso, device="cpu"))


def _trajectory(rng, n, steps, sigma, escape_at=None):
    """Drifting frames; at ``escape_at`` 30 points jump 1.3 along x, out
    of the frozen grid, which forces a respec."""
    pts = rng.random((n, 3)).astype(np.float32)
    frames = [pts]
    for f in range(1, steps):
        nxt = _drift(rng, frames[-1], sigma)
        if f == escape_at:
            nxt[:30, 0] += np.float32(1.3)
        frames.append(nxt)
    return frames


MODES = {"knn": dict(radius=0.1, k=8, knn_window="exact"),
         "range": dict(radius=0.1, k=8, mode="range")}


@pytest.mark.parametrize("mode", list(MODES))
def test_session_matches_reference_step_by_step(mode):
    """Fast replays, replans and one respec: the same branch, counters and
    results on every step, and the same lifecycle counters."""
    rng = np.random.default_rng(11)
    frames = _trajectory(rng, 1000, 8, 0.002, escape_at=5)
    jsess, tsess = _pair(frames[0], MODES[mode], dict(query_tile=128))
    seen = set()
    for f in frames:
        jres, tres = jsess.step(f), tsess.step(f)
        _assert_same_step(jsess, tsess)
        _assert_same_result(jres, tres)
        _assert_oracle_exact(tres, f, f, 0.1, 8, mode)
        seen.add((tsess.report.fast, tsess.report.respecced))
    assert {(True, False), (False, False), (False, True)} <= seen
    assert _counters(jsess.stats()) == _counters(tsess.stats())
    assert tsess.stats()["respecs"] == 1
    assert dataclasses.astuple(tsess.spec) == dataclasses.astuple(jsess.spec)


@pytest.mark.parametrize("mode", list(MODES))
def test_session_pallas_path_matches_reference(mode):
    """The fused path on both sides: ``bin_disp_tile`` and
    ``knn_tile_anchored`` (plain versions here, interpret mode in the
    reference)."""
    rng = np.random.default_rng(12)
    frames = _trajectory(rng, 400, 3, 0.0015)
    jsess, tsess = _pair(frames[0], MODES[mode],
                         dict(use_pallas=True, query_tile=128))
    for f in frames:
        jres, tres = jsess.step(f), tsess.step(f)
        _assert_same_step(jsess, tsess)
        _assert_same_result(jres, tres)
    assert _counters(jsess.stats()) == _counters(tsess.stats())
    assert tsess.stats()["fast_steps"] >= 1


def test_session_external_queries_match_reference():
    rng = np.random.default_rng(13)
    pts = rng.random((900, 3)).astype(np.float32)
    qs = rng.random((300, 3)).astype(np.float32)
    params = dict(radius=0.12, k=8, knn_window="exact")
    jsess, tsess = _pair(pts, params, dict(query_tile=128))
    for _ in range(5):
        jres, tres = jsess.step(pts, qs), tsess.step(pts, qs)
        _assert_same_step(jsess, tsess)
        _assert_same_result(jres, tres)
        pts = _drift(rng, pts, 0.002)
        qs = _drift(rng, qs, 0.003)
    assert _counters(jsess.stats()) == _counters(tsess.stats())


@pytest.mark.parametrize("self_query", [True, False])
def test_session_resumed_from_carried_state(self_query):
    """A port session started from the reference session's mid-trajectory
    state (index, captured plan, anchor queries) steps as the reference
    does from there."""
    rng = np.random.default_rng(14)
    frames = _trajectory(rng, 800, 7, 0.002)
    qs = [rng.random((256, 3)).astype(np.float32)]
    for _ in range(6):
        qs.append(_drift(rng, qs[-1], 0.002))
    jp = jc.SearchParams(radius=0.1, k=8, knn_window="exact")
    jo = jc.SearchOpts(query_tile=128)
    jsess = jc.SimulationSession(frames[0], jp, jo)

    def jstep(i):
        return (jsess.step(frames[i]) if self_query
                else jsess.step(frames[i], qs[i]))

    for i in range(3):
        jstep(i)
    index, plan = jsess.index, jsess._plan
    grid = index.grid
    aq = jsess._anchor_queries
    tsess = session_from_arrays(
        np.asarray(index.points), np.asarray(grid.dense),
        np.asarray(grid.counts), np.asarray(grid.sat),
        np.asarray(grid.overflow), np.asarray(index.anchor_points), None,
        spec=dataclasses.asdict(grid.spec), params=dataclasses.asdict(jp),
        opts=dataclasses.asdict(jo),
        plan=dict(perm=np.asarray(plan.perm),
                  tile_levels=np.asarray(plan.tile_levels), nq=plan.nq,
                  tile=plan.tile, ladder=plan.ladder),
        anchor_queries=None if aq is None else np.asarray(aq),
        sopts=dataclasses.asdict(jsess.sopts), device="cpu")
    for i in range(3, 7):
        jres = jstep(i)
        tres = (tsess.step(frames[i]) if self_query
                else tsess.step(frames[i], qs[i]))
        _assert_same_step(jsess, tsess)
        _assert_same_result(jres, tres)
    st = tsess.stats()
    assert st["steps"] == 4 and st["fast_steps"] >= 1


# ---------------------------------------------------------------------------
# the reference's session contract (tests/test_dynamic.py) on the port
# ---------------------------------------------------------------------------

def _session(pts, params, opts=None, sopts=None):
    return tc.SimulationSession(pts, params, opts or tc.SearchOpts(),
                                sopts or tc.SessionOpts(), device="cpu")


@pytest.mark.parametrize("mode", ["knn", "range"])
def test_session_exact_on_moving_sequence(rng, mode):
    pts = rng.random((1400, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.1, k=8, mode=mode, knn_window="exact")
    sess = _session(pts, params)
    saw_fast = saw_replan = False
    for _ in range(7):
        res = sess.step(pts)
        _assert_oracle_exact(res, pts, pts, 0.1, 8, mode)
        saw_fast |= sess.report.fast
        saw_replan |= sess.report.replanned
        pts = _drift(rng, pts, 0.002)
    assert saw_fast and saw_replan
    assert sess.stats()["respecs"] == 0


def test_session_external_queries_exact(rng):
    pts = rng.random((1200, 3)).astype(np.float32)
    qs = rng.random((300, 3)).astype(np.float32)
    sess = _session(pts, tc.SearchParams(radius=0.12, k=8,
                                         knn_window="exact"))
    for _ in range(5):
        res = sess.step(pts, qs)
        _assert_oracle_exact(res, pts, qs, 0.12, 8)
        pts = _drift(rng, pts, 0.002)
        qs = _drift(rng, qs, 0.002)


def test_session_steady_state_one_transfer_per_step(rng):
    """Below-threshold steps replay the captured plan: no replan, no stats
    fetch, and exactly one blocking transfer (the packed telemetry) per
    step."""
    pts = rng.random((1500, 3)).astype(np.float32)
    sess = _session(pts, tc.SearchParams(radius=0.1, k=8))
    sess.step(pts)
    for _ in range(5):
        pts = _drift(rng, pts, 0.0004)
        sess.step(pts)
        assert sess.report.fast
        assert not sess.report.replanned and not sess.report.respecced
    st = sess.stats()
    assert st["fast_steps"] == 5 and st["replans"] == 1
    assert st["stats_fetches"] == 0
    assert st["host_syncs"] == st["steps"] == 6
    assert "step_cache_size" not in st


def test_session_replans_when_displacement_exceeds_threshold(rng):
    pts = rng.random((1000, 3)).astype(np.float32)
    sess = _session(pts, tc.SearchParams(radius=0.1, k=8))
    sess.step(pts)
    cell = sess.spec.cell_size
    pts2 = pts.copy()
    pts2[17] += np.float32([cell, 0, 0])
    sess.step(pts2)
    assert sess.report.replanned and not sess.report.respecced
    assert sess.stats()["replans"] == 2
    assert sess.report.max_disp == pytest.approx(cell, rel=1e-5)


def test_session_respec_on_escape_and_overflow(rng):
    pts = rng.random((900, 3)).astype(np.float32) * 0.5
    params = tc.SearchParams(radius=0.08, k=8, knn_window="exact")
    sess = _session(pts, params)
    sess.step(pts)
    old_spec = sess.spec
    far = (pts + np.float32([2.0, 0.0, 0.0])).astype(np.float32)
    res = sess.step(far)
    assert sess.report.respecced and sess.report.oob > 0
    assert sess.spec is not old_spec
    _assert_oracle_exact(res, far, far, 0.08, 8)
    assert sess.stats()["host_syncs"] == 3     # telemetry, points, telemetry
    sess.step((far + 0.0005).astype(np.float32))
    assert sess.report.fast

    sess2 = _session(pts, params, sopts=tc.SessionOpts(capacity_slack=1.0))
    sess2.step(pts)
    squeezed = pts.copy()
    squeezed[:300] = pts[0]
    res = sess2.step(squeezed)
    assert sess2.report.respecced and sess2.report.overflow > 0
    _assert_oracle_exact(res, squeezed, squeezed, 0.08, 8)
    assert sess2.stats()["respecs"] == 1


def test_respec_hysteresis_logarithmic(rng):
    """Each respec plans geometrically more headroom: a constant-velocity
    escape triggers O(log frames) respecs, every step oracle-exact."""
    pts = rng.random((400, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.1, k=4, knn_window="exact")
    sess = _session(pts, params, sopts=tc.SessionOpts(max_dim=48))
    steps = 24
    vel = np.float32([3.0 * 0.1, 0.0, 0.0])
    respec_frames = []
    for f in range(steps):
        cur = (pts + f * vel).astype(np.float32)
        res = sess.step(cur)
        if sess.report.respecced:
            respec_frames.append(f)
        _oi, od, oc = brute_force_search(torch.from_numpy(cur),
                                         torch.from_numpy(cur), 0.1, 4)
        np.testing.assert_array_equal(oc.numpy(), res.counts.numpy())
        d_ref = np.where(np.isinf(od.numpy()), -1.0, od.numpy())
        d_got = np.where(np.isinf(res.distances2.numpy()), -1.0,
                         res.distances2.numpy())
        np.testing.assert_allclose(d_got, d_ref, atol=1e-5)
    respecs = sess.stats()["respecs"]
    assert respecs <= int(math.ceil(math.log2(steps * 3))) + 2, respecs
    assert respecs < steps / 2
    gaps = np.diff([0] + respec_frames)
    assert respecs >= 2 and (gaps[-1] >= gaps[0])

    sess0 = _session(pts, params,
                     sopts=tc.SessionOpts(respec_growth=1.0, max_dim=48))
    for f in range(10):
        sess0.step((pts + f * vel).astype(np.float32))
    assert sess0.stats()["respecs"] >= 8


def test_session_respec_disabled_raises(rng):
    pts = rng.random((400, 3)).astype(np.float32)
    sess = _session(pts, tc.SearchParams(radius=0.1, k=4),
                    sopts=tc.SessionOpts(auto_respec=False))
    sess.step(pts)
    with pytest.raises(RuntimeError, match="frozen grid"):
        sess.step(pts + np.float32([3.0, 0, 0]))
    # the session stays usable: the next in-bounds step replans
    res = sess.step(pts)
    assert sess.report.replanned
    _assert_oracle_exact(res, pts, pts, 0.1, 4)


def test_session_self_query_shares_device_buffer(rng):
    """``step(points)`` searches over the one buffer; results equal the
    explicit two-array call."""
    pts = rng.random((800, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.1, k=8, knn_window="exact")
    s1, s2 = _session(pts, params), _session(pts, params)
    buf = torch.from_numpy(pts)
    r1 = s1.step(buf)
    assert s1.index.points is buf               # no copy of the caller's
    r2 = s2.step(pts, pts.copy())
    assert torch.equal(r1.counts, r2.counts)
    assert torch.equal(r1.distances2, r2.distances2)


@pytest.mark.parametrize("self_query", [True, False])
def test_session_in_place_update_of_callers_tensor(rng, self_query):
    """A step loop that moves its own tensor in place between steps
    (``pos += vel * dt``): the plan's anchors are snapshots, so a move
    past the threshold still replans and the results stay exact."""
    pts = rng.random((900, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.1, k=8, knn_window="exact")
    sess = _session(pts, params)
    buf = torch.from_numpy(pts.copy())
    qbuf = buf if self_query else torch.from_numpy(
        rng.random((300, 3)).astype(np.float32))

    def step():
        return sess.step(buf) if self_query else sess.step(buf, qbuf)

    step()
    cell = sess.spec.cell_size
    # a drift below the threshold, in place: the plan is replayed
    buf.add_(torch.full((3,), 0.1 * cell)).clamp_(0.0, 1.0)
    res = step()
    assert sess.report.fast
    assert sess.report.max_disp > 0.0
    _assert_oracle_exact(res, buf.numpy(), qbuf.numpy(), 0.1, 8)
    # every moved query (self-query: every point) goes elsewhere in the box
    qbuf.copy_(torch.from_numpy(rng.random(tuple(qbuf.shape))
                                .astype(np.float32)))
    res = step()
    assert sess.report.replanned and not sess.report.respecced
    _assert_oracle_exact(res, buf.numpy(), qbuf.numpy(), 0.1, 8)
    # and once more, now from the replanned state
    qbuf.copy_(torch.from_numpy(rng.random(tuple(qbuf.shape))
                                .astype(np.float32)))
    res = step()
    assert sess.report.replanned
    _assert_oracle_exact(res, buf.numpy(), qbuf.numpy(), 0.1, 8)


def test_session_switching_query_sets_replans(rng):
    pts = rng.random((700, 3)).astype(np.float32)
    qs = rng.random((700, 3)).astype(np.float32)
    sess = _session(pts, tc.SearchParams(radius=0.11, k=8,
                                         knn_window="exact"))
    sess.step(pts)
    res = sess.step(pts, qs)
    assert sess.report.replanned
    _assert_oracle_exact(res, pts, qs, 0.11, 8)
    res = sess.step(pts)
    assert sess.report.replanned
    _assert_oracle_exact(res, pts, pts, 0.11, 8)


def test_session_pallas_path(rng):
    """The session on the fused path: ``bin_disp_tile`` and
    ``knn_tile_anchored`` (their plain versions on the CPU)."""
    pts = rng.random((600, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.12, k=8, knn_window="exact")
    sess = _session(pts, params, tc.SearchOpts(use_pallas=True,
                                               query_tile=128))
    before = tup.bin_disp_tile.launches
    for _ in range(3):
        res = sess.step(pts)
        _assert_oracle_exact(res, pts, pts, 0.12, 8)
        pts = _drift(rng, pts, 0.0005)
    assert sess.stats()["fast_steps"] >= 1
    assert tup.bin_disp_tile.launches == before   # no kernel on the CPU


def test_session_grid_donation_alias_safety(rng):
    """``donate_grid=True``: each step re-bins into the session-owned dense
    grid's storage, while the caller's points tensor is never written,
    across replays, replans and a respec."""
    pts = rng.random((800, 3)).astype(np.float32)
    params = tc.SearchParams(radius=0.1, k=8, knn_window="exact")
    sess = _session(pts, params, sopts=tc.SessionOpts(donate_grid=True))
    caller = torch.from_numpy(pts.copy())
    ptr = sess.index.grid.dense.data_ptr()
    res = sess.step(caller)
    _assert_oracle_exact(res, pts, pts, 0.1, 8)
    np.testing.assert_array_equal(caller.numpy(), pts)
    assert sess.index.grid.dense.data_ptr() == ptr
    pts2 = _drift(rng, pts, 0.0003)
    res = sess.step(pts2)
    _assert_oracle_exact(res, pts2, pts2, 0.1, 8)
    assert sess.report.fast and sess.index.grid.dense.data_ptr() == ptr
    big = pts2.copy()
    big[5] += np.float32([sess.spec.cell_size, 0, 0])
    res = sess.step(big)
    _assert_oracle_exact(res, big, big, 0.1, 8)
    far = (big + np.float32([4.0, 0, 0])).astype(np.float32)
    res = sess.step(far)
    assert sess.report.respecced
    _assert_oracle_exact(res, far, far, 0.1, 8)

    # the default on the CPU does not donate
    sess2 = _session(pts, params)
    ptr2 = sess2.index.grid.dense.data_ptr()
    sess2.step(pts)
    assert sess2.index.grid.dense.data_ptr() != ptr2


def test_session_defaults_to_cuda():
    """Without a CUDA device and without ``device="cpu"`` the session
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.SimulationSession(pts, tc.SearchParams(radius=0.2, k=4))


def test_session_opts_validated():
    with pytest.raises(ValueError, match="reuse_margin_cells"):
        tc.SimulationSession(np.zeros((4, 3), np.float32),
                             tc.SearchParams(radius=0.2, k=4),
                             sopts=tc.SessionOpts(reuse_margin_cells=1),
                             device="cpu")
    with pytest.raises(ValueError, match="displacement_frac"):
        validate_session_opts(tc.SessionOpts(displacement_frac=0.0))


@pytest.mark.cuda
def test_session_on_card_one_transfer_per_step():
    """On the card: exact results through the fused path, the update and the
    search launched once per step, and one blocking transfer per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import warnings
    from repro_torch.kernels import knn_tile as tknn
    rng = np.random.default_rng(15)
    frames = _trajectory(rng, 3000, 4, 0.001)
    params = tc.SearchParams(radius=0.08, k=8, knn_window="exact")
    sess = tc.SimulationSession(frames[0], params,
                                tc.SearchOpts(use_pallas=True))
    for f in frames:
        cur = torch.from_numpy(f).cuda()
        torch.cuda.synchronize()
        b0, k0 = tup.bin_disp_tile.launches, tknn.knn_tile_anchored.launches
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = sess.step(cur)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
        assert tup.bin_disp_tile.launches == b0 + 1
        assert tknn.knn_tile_anchored.launches == k0 + 1
        torch.cuda.synchronize()
        _assert_oracle_exact(
            tc.SearchResult(res.indices.cpu(), res.distances2.cpu(),
                            res.counts.cpu()), f, f, 0.08, 8)
