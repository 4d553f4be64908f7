"""The port's request-scoped telemetry (``repro_torch.obs``: trace context,
``slo``, ``flight``, ``perfetto``, ``openmetrics``) against the JAX
reference, and the reference's contract tests (``tests/test_obs_serve.py``)
on the port's service.

Exact parity, on the same event sequences: SLO attainment, burn rate,
snapshots and the summary table; the OpenMetrics text of one scrape; the
Perfetto trace-event names and phases of the same serve trace.

The request timeline has one clock: the ``resolve`` span starts at the
request's admission instant on the ``perf_counter`` clock, so the spans of
a request cover admission to resolution with no gap and no tolerance.

The reference's ``test_serve_variant_jaxpr_identical_telemetry_on_off``
compares jaxprs; the port has none. Its counterpart compares what the port
has: with spans, an SLO target and the flight recorder on and off, the
results are bitwise equal, the batch reports and host syncs equal, and the
port's kernel-module calls (counted with a monkeypatched wrapper) the
same sequence; on the card (a ``cuda`` test) so are the device operations
``torch.profiler`` counts and the synchronising calls.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
from repro.core import SearchParams as JParams
from repro.obs import slo as jslo
import repro_torch.api as api
from repro_torch import obs
from repro_torch.core import SearchOpts, SearchParams, SimulationSession
from repro_torch.obs import flight, slo
from repro_torch.reliability import FaultPlan, faults
import repro_torch.serve as tserve
from repro_torch.serve import CircuitOpen, NeighborService, Rejected, \
    ServeOpts

SRC = Path(__file__).resolve().parents[1] / "src"
P_A = SearchParams(radius=0.11, k=8, knn_window="exact")
P_B = SearchParams(radius=0.15, k=4, knn_window="exact")
CPU = "cpu"

SERVE_SPAN_NAMES = {"admit", "enqueue", "drain", "stage", "launch",
                    "sync", "split", "resolve"}


@pytest.fixture(autouse=True)
def clean_obs():
    obs.reset()
    jobs.reset()
    faults.configure(None)
    yield
    faults.configure(None)
    obs.configure()
    flight.configure()
    slo.configure(from_env=True)
    obs.reset()
    jobs.configure()
    jobs.flight.configure()
    jslo.configure(from_env=True)
    jobs.reset()


def _assert_bitwise(got, ref):
    assert torch.equal(got.indices, ref.indices)
    assert torch.equal(got.counts, ref.counts)
    da = torch.where(torch.isinf(got.distances2), -1.0, got.distances2)
    db = torch.where(torch.isinf(ref.distances2), -1.0, ref.distances2)
    assert torch.equal(da, db)


# ------------------------------------------------------------ trace context


def test_trace_scope_pins_and_unpins():
    obs.configure(mode="log")
    assert obs.current_trace() is None
    with obs.trace_scope("req-a"):
        assert obs.current_trace() == "req-a"
        with obs.span("inner"):
            pass
        with obs.trace_scope("req-b"):
            assert obs.current_trace() == "req-b"
        assert obs.current_trace() == "req-a"
    assert obs.current_trace() is None
    rec = obs.recent_spans()[-1]
    assert rec["name"] == "inner" and rec["trace"] == "req-a"
    assert "t0_s" in rec and "tid" in rec


def test_explicit_trace_attr_overrides_scope():
    obs.configure(mode="log")
    with obs.trace_scope("scoped"):
        obs.record_span("a", 0.001, trace="explicit")
        with obs.span("b", trace="explicit2"):
            pass
    recs = {r["name"]: r for r in obs.recent_spans()}
    assert recs["a"]["trace"] == "explicit"
    assert recs["b"]["trace"] == "explicit2"
    assert "trace" not in (recs["a"].get("attrs") or {})


def test_timeline_matches_trace_and_trace_ids():
    obs.configure(mode="log")
    obs.record_span("admit", 0.001, t0_s=1.0, trace="req-1")
    obs.record_span("admit", 0.001, t0_s=1.5, trace="req-2")
    obs.record_span("drain", 0.002, t0_s=2.0, trace_ids=["req-1", "req-2"])
    obs.record_span("resolve", 0.001, t0_s=3.0, trace="req-1")
    tl = obs.timeline("req-1")
    assert [r["name"] for r in tl] == ["admit", "drain", "resolve"]
    assert [r["t0_s"] for r in tl] == [1.0, 2.0, 3.0]
    assert [r["name"] for r in obs.timeline("req-2")] == ["admit", "drain"]
    assert obs.timeline("req-none") == []


# ------------------------------------------- per-request serve timeline


@pytest.mark.parametrize("pipeline", [0, 1])
def test_serve_request_timeline_covers_admission_to_resolution(rng,
                                                               pipeline):
    """Every future's spans, sorted by start, form one contiguous interval
    from admission to resolution: each span starts no later than the union
    of the ones before it ends, exactly (one clock, no tolerance); the
    ``resolve`` span starts at the admission instant, inside ``admit``."""
    obs.configure(mode="log")
    svc = NeighborService(ServeOpts(max_batch=512, pipeline=pipeline),
                          device=CPU)
    svc.register_scene("s0", rng.random((900, 3)).astype(np.float32))
    futs = [svc.submit("s0", rng.random((16, 3)).astype(np.float32), P_A)
            for _ in range(4)]
    svc.drain()
    for f in futs:
        f.result(timeout=30)
        assert f.trace_id.startswith("req-")
        tl = obs.timeline(f.trace_id)
        names = [r["name"] for r in tl]
        assert names[0] == "admit" and SERVE_SPAN_NAMES <= set(names)
        covered_to = tl[0]["t0_s"]
        for r in tl:
            assert r["t0_s"] <= covered_to, f"gap before {r['name']}"
            covered_to = max(covered_to, r["t0_s"] + r["dur_s"])
        admit = tl[0]
        resolve = next(r for r in tl if r["name"] == "resolve")
        assert resolve["attrs"]["outcome"] == "ok"
        assert resolve["attrs"]["tenant"] == "s0"
        assert admit["t0_s"] <= resolve["t0_s"] <= \
            admit["t0_s"] + admit["dur_s"]
        assert covered_to == max(r["t0_s"] + r["dur_s"] for r in tl)
        assert resolve["t0_s"] + resolve["dur_s"] >= max(
            r["t0_s"] + r["dur_s"] for r in tl if r is not resolve)
    assert len({f.trace_id for f in futs}) == len(futs)


def test_live_session_serve_traced_parity_and_sync_attribution(rng):
    obs.configure(mode="log")
    pts = rng.random((400, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    sess.step(pts)
    base_syncs = sess.stats()["host_syncs"]
    svc = NeighborService(device=CPU)
    svc.register_session("sim", sess)
    cur, futs, n_steps = pts, [], 4
    for _ in range(n_steps):
        cur = np.clip(cur + rng.normal(0, 0.001, cur.shape), 0,
                      1).astype(np.float32)
        sess.step(cur)
        q = rng.random((10, 3)).astype(np.float32)
        fut = svc.submit("sim", q, P_A)
        svc.drain()
        _assert_bitwise(fut.result(timeout=30), api.query(sess.index, q))
        futs.append(fut)
    st = sess.stats()
    assert st["host_syncs"] == base_syncs + n_steps
    assert st["stats_fetches"] == 0
    sst = svc.stats()
    assert sst["host_syncs"] == sst["batches"]
    step_spans = [r for r in obs.recent_spans() if r["name"] == "step"]
    assert len(step_spans) >= n_steps
    for r in step_spans:
        assert "trace" not in r
        assert "trace_ids" not in (r.get("attrs") or {})
    for fut in futs:
        names = [r["name"] for r in obs.timeline(fut.trace_id)]
        assert names[0] == "admit" and "resolve" in names
        assert "step" not in names


# ------------------------------------- parity: full telemetry on vs off


def _record_kernel_calls(monkeypatch):
    from repro_torch.core import api as core_api
    from repro_torch.kernels import ops
    calls = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def logged(*args, **kw):
            calls.append((name, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else
                a if isinstance(a, (int, float, bool, str, tuple)) else
                type(a).__name__ for a in args)))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, logged)

    wrap(ops, "knn_tile_anchored")
    wrap(core_api, "window_tile_search")
    return calls


def _run_seeded_trace(seed, opts, n=16):
    rng = np.random.default_rng(seed)
    scenes = {f"s{i}": rng.random((700 + 100 * i, 3)).astype(np.float32)
              for i in range(2)}
    svc = NeighborService(ServeOpts(max_batch=256, max_pending=100_000),
                          device=CPU)
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
    futs = []
    for _ in range(n):
        sid = f"s{int(rng.integers(2))}"
        p = (P_A, P_B)[int(rng.integers(2))]
        q = rng.random((int(rng.integers(4, 40)), 3)).astype(np.float32)
        futs.append(svc.submit(sid, q, p, opts))
    reports = svc.drain()
    return [f.result(timeout=30) for f in futs], reports, svc.stats()


@pytest.mark.parametrize("pallas", [False, True])
def test_serve_drain_identical_with_full_telemetry_on_vs_off(
        monkeypatch, pallas):
    """Spans + SLO target + flight recording on vs everything off: the same
    bitwise results, batch reports and host syncs, and the same sequence
    of kernel-module calls."""
    opts = SearchOpts(use_pallas=pallas, query_tile=64)
    calls = _record_kernel_calls(monkeypatch)

    def run(telemetry):
        obs.reset()
        del calls[:]
        if telemetry:
            obs.configure(mode="log")
            slo.configure(slo.SLOTarget(latency_s=60.0, objective=0.99))
            flight.configure(enabled=True, path=os.devnull)
        else:
            obs.configure(mode="off")
            slo.configure(None)
            flight.configure(enabled=False)
        return (*_run_seeded_trace(123, opts), list(calls))

    res_off, rep_off, st_off, calls_off = run(False)
    res_on, rep_on, st_on, calls_on = run(True)
    assert rep_off == rep_on
    assert st_off["host_syncs"] == st_on["host_syncs"]
    assert st_off["batches"] == st_on["batches"]
    assert calls_off == calls_on and calls_off
    assert {c[0] for c in calls_on} == (
        {"knn_tile_anchored"} if pallas else {"window_tile_search"})
    for a, b in zip(res_off, res_on):
        _assert_bitwise(a, b)
    assert any(r["name"] == "resolve" for r in obs.recent_spans())
    assert slo.BOARD.tenants() == ["s0", "s1"]


# ------------------------------------------------------------------- SLO


def test_slo_target_parse_and_validate():
    t = slo.SLOTarget.parse("latency_ms:250,objective:0.99,window_s:300")
    assert t.latency_s == pytest.approx(0.25)
    assert t.objective == 0.99 and t.window_s == 300.0
    assert t.error_budget() == pytest.approx(0.01)
    assert t.spec() == jslo.SLOTarget.parse(
        "latency_ms:250,objective:0.99,window_s:300").spec()
    rt = slo.SLOTarget.parse(t.spec())
    assert rt.latency_s == t.latency_s and rt.objective == t.objective
    for bad in ("bogus:1", "latency_ms"):
        with pytest.raises(ValueError):
            slo.SLOTarget.parse(bad)
    with pytest.raises(ValueError):
        slo.SLOTarget(objective=0.0)
    with pytest.raises(ValueError):
        slo.SLOTarget(latency_s=-1.0)


def _slo_events(rng):
    """A seeded sequence of (tenant, outcome, latency, now, occupancy)."""
    outcomes = ("ok", "ok", "ok", "degraded", "expired", "rejected",
                "circuit_open", "error", "bogus")
    out, now = [], 0.0
    for _ in range(300):
        now += float(rng.exponential(0.5))
        oc = outcomes[int(rng.integers(len(outcomes)))]
        lat = (float(rng.exponential(0.08))
               if oc in ("ok", "degraded") else None)
        occ = float(rng.random()) if lat is not None else None
        out.append((f"t{int(rng.integers(3))}", oc, lat, now, occ))
    return out


def _feed(board_mod, events, strict):
    board = board_mod.SLOBoard()
    board.configure(board_mod.SLOTarget(latency_s=0.1, objective=0.9,
                                        window_s=20.0))
    board.set_target("t2", strict)
    for tenant, oc, lat, now, occ in events:
        board.record(tenant, oc, lat, now=now, occupancy=occ)
    return board


def test_slo_attainment_burn_and_snapshot_match_reference(rng):
    events = _slo_events(rng)
    end = events[-1][3]
    tb = _feed(slo, events, slo.SLOTarget(latency_s=0.05, objective=0.999,
                                          window_s=50.0))
    jb = _feed(jslo, events, jslo.SLOTarget(latency_s=0.05,
                                            objective=0.999, window_s=50.0))
    for now in (end / 2, end, end + 15.0):
        for tenant in ("t0", "t1", "t2", "idle"):
            assert tb.attainment(tenant, now=now) == \
                jb.attainment(tenant, now=now)
            assert tb.burn_rate(tenant, now=now) == \
                jb.burn_rate(tenant, now=now)
        assert tb.snapshot(now=now) == jb.snapshot(now=now)
        assert tb.summary(now=now) == jb.summary(now=now)
        assert tb.violations(now=now) == jb.violations(now=now)
    assert tb.violations(now=end)                # the gate has teeth


def test_slo_windowed_attainment_and_burn():
    board = slo.SLOBoard()
    board.configure(slo.SLOTarget(latency_s=0.1, objective=0.9,
                                  window_s=10.0))
    for _ in range(5):
        board.record("t", "error", now=0.0)
    for _ in range(8):
        board.record("t", "ok", 0.01, now=100.0)
    board.record("t", "expired", now=100.0)
    board.record("t", "ok", 5.0, now=100.0)
    att = board.attainment("t", now=105.0)
    assert att == pytest.approx(8 / 10)
    assert board.burn_rate("t", now=105.0) == pytest.approx(2.0)
    assert board.violations(now=105.0) == {"t": (att, 0.9)}
    assert board.attainment("idle") == 1.0 and board.burn_rate("idle") == 0
    snap = board.snapshot(now=105.0)["t"]
    assert snap["requests"] == 15
    assert snap["outcomes"]["error"] == 5 and snap["outcomes"]["ok"] == 9


def test_service_attributes_every_terminal_outcome(rng):
    pts = rng.random((500, 3)).astype(np.float32)
    q = rng.random((8, 3)).astype(np.float32)
    svc = NeighborService(ServeOpts(max_batch=256), device=CPU)
    svc.register_scene("s0", pts)
    svc.submit("s0", q, P_A)
    svc.drain()
    svc.submit("s0", q, P_A, now=0.0, deadline_s=0.5)
    svc.drain(now=10.0)
    tight = NeighborService(ServeOpts(max_pending=4), device=CPU)
    tight.register_scene("s0", pts)
    with pytest.raises(Rejected):
        tight.submit("s0", rng.random((64, 3)).astype(np.float32), P_A)
    soft = NeighborService(ServeOpts(max_pending=4, degrade=True,
                                     degrade_hard=100.0, max_batch=256),
                           device=CPU)
    soft.register_scene("s0", pts)
    soft.submit("s0", rng.random((64, 3)).astype(np.float32), P_A)
    soft.drain()
    # a cooldown no loaded test machine outlasts between drain and submit
    broken = NeighborService(ServeOpts(retries=0, breaker_n=1,
                                       breaker_cooldown_s=600.0), device=CPU)
    broken.register_scene("s0", pts)
    with faults.scoped(FaultPlan(launch=1.0, scene="s0")):
        f = broken.submit("s0", q, P_A)
        broken.drain()
        with pytest.raises(Exception):
            f.result()
        with pytest.raises(CircuitOpen):
            broken.submit("s0", q, P_A)
    oc = slo.snapshot()["s0"]["outcomes"]
    for name in ("ok", "degraded", "expired", "rejected", "error",
                 "circuit_open"):
        assert oc[name] >= 1, name


# -------------------------------------------------------- flight recorder


def test_flight_dump_on_breaker_trip(rng, tmp_path):
    out = str(tmp_path / "flight.json")
    flight.configure(enabled=True, path=out)
    obs.configure(mode="log")
    svc = NeighborService(ServeOpts(retries=0, breaker_n=1), device=CPU)
    svc.register_scene("bad", rng.random((400, 3)).astype(np.float32))
    with faults.scoped(FaultPlan(launch=1.0, scene="bad")):
        fut = svc.submit("bad", rng.random((8, 3)).astype(np.float32), P_A)
        svc.drain()
    with pytest.raises(Exception):
        fut.result()
    assert flight.dump_count() == 1
    doc = json.loads(open(out).read())
    assert doc["schema"] == "repro.obs/flight-v1"
    assert doc["reason"] == "breaker_open:bad"
    kinds = [e["kind"] for e in doc["events"]]
    assert "breaker_trip" in kinds and "batch_failed" in kinds
    assert doc["metrics"]["metrics"]
    assert "bad" in doc["slo"]
    assert any(s["name"] == "admit" for s in doc["spans"])


def test_flight_dump_on_pump_crash(rng, tmp_path, monkeypatch):
    out = str(tmp_path / "crash.json")
    flight.configure(enabled=True, path=out)
    svc = NeighborService(device=CPU)
    svc.register_scene("s0", rng.random((400, 3)).astype(np.float32))
    fut = svc.submit("s0", rng.random((8, 3)).astype(np.float32), P_A)

    def boom(*a, **k):
        raise RuntimeError("pump meltdown")

    monkeypatch.setattr(svc, "_drop_dead", boom)
    with pytest.raises(RuntimeError, match="pump meltdown"):
        svc.pump(force=True)
    assert fut.done()
    doc = json.loads(open(out).read())
    assert doc["reason"] == "pump_crash"
    assert any(e["kind"] == "pump_crash" for e in doc["events"])


def test_flight_disabled_records_but_does_not_dump(tmp_path):
    flight.configure(enabled=False, path=str(tmp_path / "no.json"))
    flight.note("drain", batch=1)
    assert flight.dump("anything") is None
    assert not (tmp_path / "no.json").exists()
    assert [e["kind"] for e in flight.events()] == ["drain"]
    forced = str(tmp_path / "forced.json")
    assert flight.dump("debug", path=forced) == forced
    assert json.loads(open(forced).read())["reason"] == "debug"


# -------------------------------------------------------------- exporters

_OM_TYPE = re.compile(r"^# TYPE [a-zA-Z_][a-zA-Z0-9_]* "
                      r"(counter|gauge|summary)$")
_OM_SAMPLE = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$")


def _scrape_events(o, o_slo):
    """The same metric and SLO event sequence into either package; keeps
    the metric sets alive for the scrape."""
    ms = o.metric_set("serve")
    ms.count("requests", 5)
    ms.count("query_rows", 123)
    ms.gauge("queue_depth", 3)
    for v in (0.01, 0.02, 0.03, 0.5):
        ms.observe("request_s", v)
    reg = o.metric_set("serve_registry")
    reg.count("admissions", 2)
    reg.gauge("resident_scenes", 2)
    o_slo.record("tenant-a", "ok", 0.01, now=1.0)
    o_slo.record("tenant-a", "rejected", now=1.5)
    o_slo.record("tenant-b", "degraded", 0.2, now=2.0, occupancy=0.5)
    o_slo.record('odd"tenant', "error", now=2.5)
    return ms, reg


def test_openmetrics_text_matches_reference():
    keep = _scrape_events(obs, slo), _scrape_events(jobs, jslo)
    text = obs.export_openmetrics()
    assert text == jobs.export_openmetrics()
    assert keep


def test_openmetrics_grammar_and_content():
    ms = obs.metric_set("serve")
    ms.count("requests", 5)
    ms.gauge("queue_depth", 3)
    for v in (0.01, 0.02, 0.03):
        ms.observe("request_s", v)
    slo.record("tenant-a", "ok", 0.01)
    slo.record("tenant-a", "rejected")
    text = obs.export_openmetrics()
    lines = text.splitlines()
    assert lines[-1] == "# EOF" and text.endswith("\n")
    declared = set()
    for ln in lines[:-1]:
        if ln.startswith("# TYPE"):
            assert _OM_TYPE.match(ln), ln
            declared.add(ln.split()[2])
        else:
            assert _OM_SAMPLE.match(ln), ln
            fam = ln.split("{")[0].split(" ")[0]
            base = re.sub(r"_(total|sum|count)$", "", fam)
            assert fam in declared or base in declared, ln
    assert "repro_serve_requests_total 5" in text
    assert "repro_serve_queue_depth 3" in text
    assert 'repro_serve_request_s{quantile="0.99"}' in text
    assert "repro_serve_request_s_count 3" in text
    assert 'repro_slo_attainment{tenant="tenant-a"} 0.5' in text
    assert ('repro_slo_outcomes_total{tenant="tenant-a",'
            'outcome="rejected"} 1') in text


def test_openmetrics_families_after_serve_trace_match_reference(rng):
    """After the same serve trace in both packages, one scrape declares
    the same families and holds the same counter samples (latencies and
    timings differ by run and are left out)."""
    scenes = {"s0": rng.random((600, 3)).astype(np.float32)}
    qs = [rng.random((int(rng.integers(1, 64)), 3)).astype(np.float32)
          for _ in range(6)]
    svcs = []
    for serve_mod, params, kw in (
            (jserve, JParams(**dataclasses.asdict(P_A)), {}),
            (tserve, P_A,
             {"device": CPU})):
        svc = serve_mod.NeighborService(serve_mod.ServeOpts(max_batch=64),
                                        **kw)
        svc.register_scene("s0", scenes["s0"])
        for q in qs:
            svc.submit("s0", q, params)
        svc.drain()
        svcs.append(svc)

    def counters(text):
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("# TYPE") or
                      re.match(r"^\S+_total(\{[^}]*\})? ", ln))

    assert counters(obs.export_openmetrics()) == \
        counters(jobs.export_openmetrics())
    assert svcs


def test_perfetto_export_trace_events(tmp_path):
    obs.configure(mode="log")
    with obs.trace_scope("req-9"):
        with obs.span("admit", tenant="s0"):
            pass
    obs.record_span("drain", 0.002, trace_ids=["req-9"])
    out = str(tmp_path / "trace.json")
    assert obs.export_perfetto(out) == out
    events = json.loads(open(out).read())["traceEvents"]
    assert len(events) == 2
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    admit = next(e for e in events if e["name"] == "admit")
    assert admit["ph"] == "X" and admit["cat"] == "repro"
    assert admit["dur"] >= 0 and isinstance(admit["pid"], int)
    assert admit["args"]["trace"] == "req-9"
    assert admit["args"]["tenant"] == "s0"
    drain = next(e for e in events if e["name"] == "drain")
    assert drain["args"]["trace_ids"] == ["req-9"]


def test_perfetto_names_and_phases_match_reference(rng):
    """The same serve trace traced in both packages: the same multiset of
    trace-event names and phases, and the same span paths."""
    scenes = {"s0": rng.random((700, 3)).astype(np.float32),
              "s1": rng.random((500, 3)).astype(np.float32)}
    trace = [(f"s{i % 2}", (P_A, P_B)[i % 3 == 0],
              rng.random((int(rng.integers(1, 40)), 3)).astype(np.float32))
             for i in range(10)]
    docs = []
    for o, serve_mod, conv, kw in (
            (jobs, jserve, lambda p: JParams(**dataclasses.asdict(p)), {}),
            (obs, tserve,
             lambda p: p, {"device": CPU})):
        o.configure(mode="log")
        svc = serve_mod.NeighborService(serve_mod.ServeOpts(max_batch=128),
                                        **kw)
        for sid, pts in scenes.items():
            svc.register_scene(sid, pts)
        for sid, p, q in trace:
            svc.submit(sid, q, conv(p))
        svc.drain()
        docs.append(o.to_trace_events())
    jdoc, tdoc = docs

    def shape(doc):
        return sorted((e["name"], e["ph"], e["cat"], e["args"]["path"])
                      for e in doc["traceEvents"])

    assert shape(tdoc) == shape(jdoc)
    assert {e["name"] for e in tdoc["traceEvents"]} >= SERVE_SPAN_NAMES


# ------------------------------------------------------------ reset safety


def test_reset_runs_registered_hooks():
    calls = []

    def hook():
        calls.append(1)

    obs.on_reset(hook)
    obs.reset()
    assert calls == [1]
    obs.on_reset(hook)
    obs.reset()
    assert calls == [1, 1]


def test_back_to_back_serve_scenarios_see_clean_counters(rng):
    def scenario():
        svc = NeighborService(device=CPU)
        svc.register_scene("s0", rng.random((500, 3)).astype(np.float32))
        futs = [svc.submit("s0", rng.random((8, 3)).astype(np.float32), P_A)
                for _ in range(3)]
        svc.drain()
        for f in futs:
            f.result(timeout=30)
        return (slo.snapshot()["s0"]["outcomes"],
                [e["kind"] for e in flight.events()])

    first_slo, first_events = scenario()
    assert first_slo["ok"] == 3 and "drain" in first_events
    obs.reset()
    assert slo.BOARD.tenants() == [] and flight.events() == []
    second_slo, second_events = scenario()
    assert second_slo == first_slo
    assert second_events == first_events


# ------------------------------------------------------------- obs_top CLI


def test_obs_top_demo_cli_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs_top", "--demo",
         "--frames", "1", "--device", CPU], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "== repro_torch obs_top ==" in proc.stdout
    assert "# per-tenant SLO" in proc.stdout
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs_top", "--frames",
             "1"], env=env, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "CUDA" in bad.stderr


# ------------------------------------------------------------------ the card


def _device_work(run):
    """Run ``run()`` on the card under ``torch.profiler`` (device activity)
    and ``torch.cuda.set_sync_debug_mode("warn")``: returns its value, the
    multiset of device operations it launched (kernels and copies, not
    annotation ranges) and its synchronising calls."""
    import collections
    import warnings
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    ops = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return out, ops, syncs


@pytest.mark.cuda
def test_serve_device_work_identical_telemetry_on_off_on_card():
    """On the card, spans + SLO target + flight recording on vs off: the
    same bitwise results and batch reports, the same device operations
    (counted by ``torch.profiler``) and the same synchronising calls, one
    per drained batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    opts = SearchOpts(use_pallas=True)

    def run(telemetry):
        obs.reset()
        if telemetry:
            obs.configure(mode="log")
            slo.configure(slo.SLOTarget(latency_s=60.0, objective=0.99))
            flight.configure(enabled=True, path=os.devnull)
        else:
            obs.configure(mode="off")
            slo.configure(None)
            flight.configure(enabled=False)
        rng = np.random.default_rng(123)
        scenes = {f"s{i}": rng.random((3000 + 500 * i, 3)).astype(
            np.float32) for i in range(2)}
        svc = NeighborService(ServeOpts(max_batch=256, max_pending=100_000))
        for sid, pts in scenes.items():
            svc.register_scene(sid, pts)
            for p in (P_A, P_B):
                v = svc.registry.get(sid).variant(p, opts)
                v.warm(256)
                v.quality_counters()
        trace = [(f"s{int(rng.integers(2))}", (P_A, P_B)[int(
            rng.integers(2))], rng.random((int(rng.integers(4, 40)), 3))
            .astype(np.float32)) for _ in range(16)]

        def serve():
            futs = [svc.submit(sid, q, p, opts) for sid, p, q in trace]
            return futs, svc.drain()

        (futs, reports), ops, syncs = _device_work(serve)
        return [f.result(timeout=60) for f in futs], reports, ops, syncs

    res_off, rep_off, ops_off, syncs_off = run(False)
    res_on, rep_on, ops_on, syncs_on = run(True)
    assert rep_off == rep_on
    assert ops_off == ops_on and ops_off
    assert syncs_off == syncs_on == len(rep_on)
    for a, b in zip(res_off, res_on):
        _assert_bitwise(a, b)
