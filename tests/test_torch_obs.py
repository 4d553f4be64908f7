"""The port's telemetry (``repro_torch.obs``) vs the reference's
``repro.obs`` on the same values: the registry's counters, gauges and
histograms, the text summary and metric schema, span paths, the trace
knob, and the packed step-telemetry vector. Then the session's use of it:
one ``SimulationSession`` step with tracing on emits the step's spans,
and results and host-sync counts are identical with tracing on and off.
Everything compares exactly (the same host arithmetic on the same
values)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import device as jdev
import repro_torch.core as tc
from repro_torch import obs


@pytest.fixture(autouse=True)
def clean_obs():
    """Every test starts with empty registries and span rings and ends with
    the trace mode re-read from the environment."""
    obs.reset()
    jobs.reset()
    yield
    obs.configure()
    jobs.configure()
    obs.reset()
    jobs.reset()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _record(o):
    """The same recording sequence into either package's registry."""
    a, b = o.metric_set("session"), o.metric_set("session")
    a.count("steps", 2)
    b.count("steps", 3)
    a.count("host_syncs")
    a.gauge("staleness_disp2", 0.25)
    for v in (0.001, 0.004, 0.002, 0.003):
        a.observe("step_s", v)
    e = o.metric_set("executor")
    e.count("queries", 4)
    e.observe("query_s", 0.002)
    return a


def _untick(rows):
    return [{k: v for k, v in r.items() if k != "tick"} for r in rows]


def test_registry_matches_reference():
    ta, ja = _record(obs), _record(jobs)
    assert ta.counters() == ja.counters() == {"steps": 2, "host_syncs": 1}
    snap_t, snap_j = ta.snapshot(), ja.snapshot()
    snap_t["staleness_disp2"].pop("tick")
    snap_j["staleness_disp2"].pop("tick")
    assert snap_t == snap_j
    assert _untick(obs.metrics_dict()["metrics"]) == \
        _untick(jobs.metrics_dict()["metrics"])
    assert obs.metrics_dict()["schema"] == "repro.obs/v1"
    assert obs.summary() == jobs.summary()
    assert "query_us" in obs.summary()


def test_histogram_percentiles_match_reference():
    th, jh = obs.Histogram(), jobs.Histogram()
    for v in range(1, 101):
        th.observe(float(v))
        jh.observe(float(v))
    assert th.percentiles() == jh.percentiles()
    assert (th.count, th.vmin, th.vmax) == (100, 1.0, 100.0)


def test_trace_knob_parsing_matches_reference():
    from repro.obs import tracing as jtr
    from repro_torch.obs import tracing as ttr
    for knob in (None, "", "0", "off", "1", "log", "2", "jsonl",
                 "/tmp/t.jsonl", "weird"):
        assert ttr._parse_knob(knob) == jtr._parse_knob(knob)


def _span_sequence(o):
    with o.span("step", slabs=2):
        with o.span("plan"):
            pass
        with o.span("launch"):
            o.record_span("compile", 0.5)
        with o.trace_scope("req-1"):
            with o.span("sync"):
                pass
    return [(s["path"], s.get("attrs"), s.get("trace"))
            for s in o.recent_spans()]


def test_spans_nest_like_reference():
    obs.configure(mode="log")
    jobs.configure(mode="log")
    got = _span_sequence(obs)
    assert got == _span_sequence(jobs)
    assert [p for p, _, _ in got] == ["step/plan", "step/launch/compile",
                                      "step/launch", "step/sync", "step"]
    assert obs.timeline("req-1")[0]["path"] == "step/sync"


def test_spans_dropped_when_off():
    """With tracing off a span's attributes, trace id and log line are
    dropped; the ring keeps its compact record (name, path, start,
    duration, thread)."""
    obs.configure(mode="off")
    with obs.trace_scope("req-1"), obs.span("query", nq=4) as sp:
        obs.record_span("compile", 0.5, groups=2)
    assert sp.duration >= 0.0
    compile_rec, query_rec = obs.recent_spans()
    assert query_rec == {"type": "span", "name": "query", "path": "query",
                         "dur_s": sp.duration, "t0_s": query_rec["t0_s"],
                         "tid": query_rec["tid"]}
    assert compile_rec["path"] == "query/compile"
    assert compile_rec["dur_s"] == 0.5 and "attrs" not in compile_rec


def test_jsonl_streaming_and_export(tmp_path):
    out = str(tmp_path / "trace.jsonl")
    obs.configure(mode="jsonl", path=out)
    with obs.span("query", nq=64):
        pass
    obs.metric_set("exec").observe("query_s", 0.004)
    assert [r["name"] for r in _read_jsonl(out) if r["type"] == "span"] \
        == ["query"]
    obs.export_jsonl(out)
    row = next(r for r in _read_jsonl(out) if r["type"] == "metric"
               and r["component"] == "exec" and r["name"] == "query_s")
    assert row["kind"] == "histogram" and "p50" in row and "p99" in row


def test_reset_runs_registered_hooks():
    calls = []
    hook = lambda: calls.append(1)          # noqa: E731
    obs.on_reset(hook)
    obs.on_reset(hook)                      # idempotent
    obs.metric_set("x").count("n")
    obs.reset()
    assert calls == [1]
    assert obs.metrics_dict()["metrics"] == []
    from repro_torch.obs import lifecycle
    lifecycle._HOOKS.remove(hook)


@pytest.mark.parametrize("disp2", [0.0, 1.5e-5, 3.0e38, float("inf")])
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("sharded", [False, True])
def test_pack_unpack_matches_reference(disp2, tail, sharded):
    """The packed vector and its unpacked dict equal the reference's on the
    same counters, header-only and with the occupancy tail, with the
    sharded session's ``migrated`` / ``halo`` slots filled or left to
    their zeros."""
    occ = np.array([3, 0, 7, 1] if tail else [], np.int32)
    extra = dict(migrated=5, halo=1234) if sharded else {}
    jvec = np.asarray(jobs.pack_step_telemetry(
        jnp.int32(3), overflow=jnp.int32(2), oob=jnp.int32(11),
        max_disp2=jnp.float32(disp2), occupancy=jnp.asarray(occ),
        **{k: jnp.int32(v) for k, v in extra.items()}))
    tvec = obs.pack_step_telemetry(
        torch.tensor(3, dtype=torch.int32),
        overflow=torch.tensor(2, dtype=torch.int32),
        oob=torch.tensor(11, dtype=torch.int32),
        max_disp2=torch.tensor(disp2, dtype=torch.float32),
        occupancy=torch.from_numpy(occ) if tail else None,
        **{k: torch.tensor(v, dtype=torch.int32) for k, v in extra.items()})
    assert tvec.dtype == torch.int32
    assert obs.TELEM_HEADER == jdev.TELEM_HEADER
    assert tvec.shape == (obs.TELEM_HEADER + occ.size,)
    np.testing.assert_array_equal(jvec, tvec.numpy())
    assert obs.unpack_step_telemetry(tvec) == jobs.unpack_step_telemetry(jvec)


def test_level_occupancy_matches_reference(rng):
    levels = rng.integers(-2, 7, 300).astype(np.int32)
    for n_levels in (1, 4, 9):
        want = np.asarray(jobs.level_occupancy(jnp.asarray(levels),
                                               n_levels))
        got = obs.level_occupancy(torch.from_numpy(levels), n_levels)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


def _jitter(rng, pts, scale=0.004):
    return np.clip(pts + rng.normal(0, scale, pts.shape).astype(np.float32),
                   0, 1).astype(np.float32)


PARAMS = tc.SearchParams(radius=0.12, k=8, knn_window="exact")


def test_session_step_emits_jsonl_telemetry(rng, tmp_path):
    """Session steps with tracing on emit the step's spans and a step-time
    histogram; the counters ride the one fetch per step."""
    out = str(tmp_path / "session.jsonl")
    obs.configure(mode="jsonl", path=out)
    pts = rng.random((500, 3)).astype(np.float32)
    sess = tc.SimulationSession(pts, PARAMS, device="cpu")
    sess.step(pts)
    sess.step(_jitter(rng, pts))
    st = sess.stats()
    obs.export_jsonl(out)
    recs = _read_jsonl(out)
    paths = {r["path"] for r in recs if r["type"] == "span"}
    assert {"step", "step/update", "step/plan", "step/launch",
            "step/sync"} <= paths
    rows = {(r["component"], r["name"]): r for r in recs
            if r["type"] == "metric"}
    hist = rows[("session", "step_s")]
    assert hist["count"] == 2 and "p50" in hist and "p99" in hist
    assert st["host_syncs"] == 2 and st["stats_fetches"] == 0
    assert any(name.startswith("level_occ_") for _, name in rows)
    assert "session" in obs.summary()


def test_session_results_and_syncs_identical_on_off(rng):
    pts0 = rng.random((400, 3)).astype(np.float32)
    traj = [pts0]
    for _ in range(2):
        traj.append(_jitter(rng, traj[-1]))

    def run(mode):
        obs.reset()
        obs.configure(mode=mode)
        sess = tc.SimulationSession(pts0, PARAMS, device="cpu")
        return [sess.step(p) for p in traj], sess.stats()

    outs_off, st_off = run("off")
    outs_on, st_on = run("log")
    for a, b in zip(outs_off, outs_on):
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.counts, b.counts)
        assert torch.equal(a.distances2, b.distances2)
    assert st_off["host_syncs"] == st_on["host_syncs"] == len(traj)
    assert st_off["stats_fetches"] == st_on["stats_fetches"] == 0


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many small tensor operations,
    which stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_session_step_emits_jsonl_telemetry(rng, tmp_path,
                                                    one_thread):
    """The sharded step's spans and its ``sharded_session`` metric rows, as
    the reference's (``tests/test_obs.py:202``), less its ``compile``
    span: the port has no jit."""
    out = str(tmp_path / "shard.jsonl")
    obs.configure(mode="jsonl", path=out)
    pts = rng.random((600, 3)).astype(np.float32)
    sess = tc.ShardedSession(pts, PARAMS, n_slabs=2, device="cpu")
    sess.step(pts)
    sess.step(_jitter(rng, pts))
    st = sess.stats()
    obs.export_jsonl(out)
    recs = _read_jsonl(out)
    paths = {r["path"] for r in recs if r["type"] == "span"}
    assert {"step", "step/update", "step/plan", "step/launch",
            "step/sync"} <= paths
    assert not any(p.endswith("compile") for p in paths)
    # the slabs' api spans fold into the step's own
    assert not paths & {"step/update/update", "step/launch/launch",
                        "step/plan/plan"}
    rows = {(r["component"], r["name"]): r for r in recs
            if r["type"] == "metric"}
    hist = rows[("sharded_session", "step_s")]
    assert hist["count"] == 2 and "p50" in hist and "p99" in hist
    for name in ("halo_rows", "migrated_rows", "steps", "host_syncs",
                 "staleness_disp2", "boost"):
        assert ("sharded_session", name) in rows, name
    assert any(c == "sharded_session" and n.startswith("level_occ_")
               for c, n in rows)
    assert st["host_syncs"] == 2 and st["host_routings"] == 1
    assert "sharded_session" in obs.summary()


def _record_kernel_calls(monkeypatch):
    """Log every call of the modules that launch kernels, as the
    functional core reaches them: the fused search, the per-tile search
    and the grid update (which launches ``bin_disp_tile``)."""
    from repro_torch.core import api as core_api
    from repro_torch.kernels import ops
    calls = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def logged(*args, **kw):
            calls.append((name, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else
                type(a).__name__ for a in args)))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, logged)

    wrap(ops, "window_search_segmented")
    wrap(core_api, "update_cell_grid")
    wrap(core_api, "window_tile_search")
    return calls


@pytest.mark.parametrize("pallas", [False, True])
def test_sharded_session_identical_on_off(rng, monkeypatch, pallas,
                                         one_thread):
    """Telemetry on vs off (``tests/test_obs.py:266``'s counterpart): the
    same bitwise results, host syncs and counters, and the same sequence
    of kernel-module calls."""
    # a box of half the unit side: a quarter of the cells a slab face, so
    # the plain version's tile of real and parked rows stays cheap
    pts0 = (rng.random((300, 3)) * 0.5).astype(np.float32)
    traj = [pts0]
    for _ in range(2):
        traj.append(np.clip(_jitter(rng, traj[-1], 0.02), 0, 0.5))
    calls = _record_kernel_calls(monkeypatch)
    opts = tc.SearchOpts(use_pallas=pallas, query_tile=64)

    def run(mode):
        obs.reset()
        obs.configure(mode=mode)
        del calls[:]
        sess = tc.ShardedSession(pts0, PARAMS, opts, n_slabs=2,
                                 device="cpu")
        outs = [sess.step(p) for p in traj]
        st = sess.stats()
        del st["t_step"]
        return outs, st, list(calls)

    outs_off, st_off, calls_off = run("off")
    outs_on, st_on, calls_on = run("log")
    for a, b in zip(outs_off, outs_on):
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.counts, b.counts)
        assert torch.equal(a.distances2, b.distances2)
    assert st_off == st_on and st_on["host_syncs"] == len(traj)
    assert st_on["migrated"] > 0
    assert calls_off == calls_on and calls_off
    assert {c[0] for c in calls_on} == {"update_cell_grid", (
        "window_search_segmented" if pallas else "window_tile_search")}


# ---------------------------------------------------------------------------
# the port's span trees, kept with tracing off
# ---------------------------------------------------------------------------

def _paths():
    return [r["path"] for r in obs.recent_spans()]


def test_same_name_span_folds_into_its_parent():
    obs.configure(mode="log")
    with obs.span("update", n=1):
        with obs.span("update", n=2) as inner:
            with obs.span("pack"):
                pass
    assert _paths() == ["update/pack", "update"]
    assert obs.recent_spans()[-1]["attrs"] == {"n": 1}
    assert inner.duration > 0.0


def test_api_query_span_tree(rng):
    """``api.query``: ``query`` over ``plan`` (``megacells``, then
    ``schedule``) and ``launch``; ``build_index`` is ``build``."""
    from repro_torch import api
    obs.configure(mode="off")
    pts = rng.random((600, 3)).astype(np.float32)
    index = api.build_index(pts, PARAMS, device="cpu")
    assert _paths() == ["build"]
    obs.reset()
    api.query(index, pts[:100])
    assert _paths() == ["query/plan/megacells", "query/plan/schedule",
                        "query/plan", "query/launch", "query"]


def test_neighbor_search_plan_stages(rng):
    """``NeighborSearch.query``'s ``plan`` holds its six stages in order,
    and ``report.t_opt`` is that span's duration."""
    obs.configure(mode="off")
    pts = rng.random((2000, 3)).astype(np.float32)
    ns = tc.NeighborSearch(pts, tc.SearchParams(radius=0.09, k=8),
                           tc.SearchOpts(), device="cpu")
    obs.reset()
    ns.query(rng.random((400, 3)).astype(np.float32))
    recs = {r["path"]: r for r in obs.recent_spans()}
    stages = [p for p in recs if p.startswith("query/plan/")]
    assert stages == [f"query/plan/{s}" for s in (
        "schedule", "fetch", "fingerprint", "partition", "bundle", "stage")]
    assert {"query", "query/plan", "query/launch", "query/sync"} <= set(recs)
    plan = recs["query/plan"]
    assert plan["dur_s"] == ns.report.t_opt
    assert sum(recs[p]["dur_s"] for p in stages) <= plan["dur_s"]
    for p in stages:
        assert recs[p]["t0_s"] >= plan["t0_s"]


def test_session_replan_and_replay_span_trees(rng):
    """A replan step runs ``api.plan_query``'s ``plan`` under ``step``; a
    replay step has no ``plan``. Re-bin and pack are ``update``, the
    search ``launch``."""
    obs.configure(mode="off")
    pts = rng.random((500, 3)).astype(np.float32)
    sess = tc.SimulationSession(pts, PARAMS, device="cpu")
    obs.reset()
    sess.step(pts)
    assert sess.report.replanned
    assert _paths() == ["step/update", "step/sync", "step/plan/megacells",
                        "step/plan/schedule", "step/plan", "step/launch",
                        "step"]
    plan = obs.recent_spans()[4]
    assert plan["dur_s"] <= sess.report.t_plan
    obs.reset()
    sess.step(_jitter(rng, pts, 1e-4))
    assert not sess.report.replanned
    assert _paths() == ["step/update", "step/sync", "step/launch", "step"]


def test_exported_span_starts_on_the_profilers_clock(tmp_path):
    """A span exported to Perfetto (and JSONL) starts within 100 us of its
    ``record_function``'s start in a ``torch.profiler`` trace, both in
    one document."""
    from torch.profiler import ProfilerActivity, profile
    obs.configure(mode="off")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with obs.span("aligned"):
                torch.ones(8).sum()
    doc = obs.to_trace_events(profile=prof)

    def starts(cat):
        return sorted(e["ts"] for e in doc["traceEvents"]
                      if e["name"] == "aligned" and e.get("cat") == cat)

    ours, kineto = starts("repro"), starts("user_annotation")
    assert len(ours) == len(kineto) == 5
    assert max(abs(a - b) for a, b in zip(ours, kineto)) < 100.0
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    out = str(tmp_path / "spans.jsonl")
    obs.export_jsonl(out)
    ts_ns = sorted(r["ts_ns"] for r in _read_jsonl(out)
                   if r["type"] == "span")
    assert max(abs(a / 1e3 - b) for a, b in zip(ts_ns, kineto)) < 100.0


def test_kernel_counters_decode_and_export(monkeypatch):
    """``kernel_counters`` decodes the walk counter's table (here a host
    stand-in for the device's): totals, the boxed rows, the split by
    signature (a boxed row apart from its level's cube) and the overflow
    row; ``summary`` and OpenMetrics carry them; ``reset`` zeros them.
    Without a launch on a card there are none."""
    from repro_torch.kernels import knn_tile
    assert obs.kernel_counters() == {}

    def key(w, skip, boxed=False):
        return ((w[0] << 42) | (w[1] << 22) | (w[2] << 2) | (int(boxed) << 1)
                | int(skip))

    table = torch.zeros((5, 6), dtype=torch.int64)
    table[0] = torch.tensor([key((7, 7, 7), False), 343, 100, 800, 51200,
                             64])
    table[1] = torch.tensor([key((7, 7, 7), False, True), 120, 60, 300,
                             19200, 64])
    table[2] = torch.tensor([key((3, 3, 5), True), 45, 20, 90, 5760, 64])
    table[4] = torch.tensor([-(1 << 63), 10, 1, 2, 128, 0])   # overflow
    monkeypatch.setitem(knn_tile._WALK, torch.device("cpu"), table)
    monkeypatch.setattr(knn_tile.knn_tile_anchored, "rows", 192)
    walk = obs.kernel_counters()["knn_tile_anchored"]
    assert {k: v for k, v in walk.items() if k != "by_signature"} == {
        "query_rows": 192, "boxed_rows": 64, "window_cells": 518,
        "occupied_cells": 181, "candidates": 1192,
        "candidate_pairs": 76288}
    sigs = {(None if s["window"] is None else tuple(s["window"]),
             s["sphere_test"], s["boxed"]): s for s in walk["by_signature"]}
    assert sigs[((7, 7, 7), True, False)]["candidates"] == 800
    assert sigs[((7, 7, 7), True, True)]["window_cells"] == 120
    assert sigs[((7, 7, 7), True, True)]["query_rows"] == 64
    assert sigs[((3, 3, 5), False, False)]["window_cells"] == 45
    assert sigs[(None, None, False)]["candidate_pairs"] == 128
    assert "candidate_pairs" in obs.summary()
    assert "boxed_rows" in obs.summary()
    text = obs.export_openmetrics()
    assert ('repro_kernel_knn_tile_anchored_candidate_pairs_total'
            '{window="7x7x7",sphere_test="true",boxed="false"} 51200') \
        in text
    assert ('repro_kernel_knn_tile_anchored_candidate_pairs_total'
            '{window="7x7x7",sphere_test="true",boxed="true"} 19200') in text
    assert "repro_kernel_knn_tile_anchored_query_rows_total 192" in text
    assert "repro_kernel_knn_tile_anchored_boxed_rows_total 64" in text
    obs.reset()
    assert int(table.abs().sum()) == 0
    assert knn_tile.knn_tile_anchored.rows == 0
