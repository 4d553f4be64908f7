"""The port's reliability layer (``repro_torch.reliability`` and the
service's failure paths) against the JAX reference, and the reference's
reliability contract tests (``tests/test_reliability.py``) on the port.

Parity, on the same event sequences: the circuit breaker's state
sequence, ``ResultQuality`` flags, ``StragglerMonitor``'s flags and EMA,
and, under one seeded ``FaultPlan``, the chaos trace's outcome counts,
service counters and injected faults in both packages.

The reference's ``test_validation_env_knob_preserves_jaxpr_and_syncs``
compares jaxprs; the port has none. Its counterpart here compares what the
port has: with ``REPRO_VALIDATE`` on and off the results are bitwise equal
and the port's kernel-module calls (counted with a monkeypatched wrapper)
are the same sequence; on the card (a ``cuda`` test) so are the device
operations ``torch.profiler`` counts and the synchronising calls.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.reliability as jrel
import repro.serve as jserve
from repro.core import SearchParams as JParams
from repro.train.fault_tolerance import StragglerMonitor as JStraggler
import repro_torch.api as api
from repro_torch import obs
from repro_torch.core import SearchOpts, SearchParams, SimulationSession
from repro_torch.reliability import (CircuitBreaker, CircuitOpen,
                                     DeadlineExceeded, FaultPlan,
                                     InjectedFault, QueryError,
                                     ResultQuality, faults, is_transient)
from repro_torch.reliability.errors import Cancelled, TransientFault
import repro_torch.serve as tserve
from repro_torch.serve import (MicroBatcher, NeighborService, Rejected,
                               ServeOpts)
from repro_torch.serve import service as service_mod
from repro_torch.train import StragglerMonitor

SRC = Path(__file__).resolve().parents[1] / "src"
P_A = SearchParams(radius=0.11, k=8, knn_window="exact")
P_B = SearchParams(radius=0.15, k=4, knn_window="exact")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    monkeypatch.delenv("REPRO_VALIDATE", raising=False)
    obs.reset()
    faults.configure(None)
    jrel.faults.configure(None)
    yield
    faults.configure(None)
    jrel.faults.configure(None)
    obs.configure()
    obs.reset()


def _assert_bitwise(got, ref):
    assert torch.equal(got.indices, ref.indices)
    assert torch.equal(got.counts, ref.counts)
    da = torch.where(torch.isinf(got.distances2), -1.0, got.distances2)
    db = torch.where(torch.isinf(ref.distances2), -1.0, ref.distances2)
    assert torch.equal(da, db)


def _svc(rng, n=600, scene="s", **kw):
    pts = rng.random((n, 3)).astype(np.float32)
    svc = NeighborService(ServeOpts(**kw), device=CPU)
    svc.register_scene(scene, pts)
    return svc, pts


def _ref(pts, params, q, opts=SearchOpts()):
    return api.query(api.build_index(pts, params, opts, device=CPU), q)


# --------------------------------------------- pure-Python units: parity


def _breaker_trace(br, events):
    """Drive one breaker through ``events``; record every gate answer and
    the state after each event."""
    out = []
    for ev, now in events:
        if ev == "allow":
            got = br.allow(now)
        elif ev == "submit":
            got = br.submit_allowed(now)
        elif ev == "retry_after":
            got = br.retry_after(now)
        elif ev == "fail":
            got = br.record_failure(now)
        else:
            got = br.record_success()
        out.append((ev, now, got, br.state, br.failures, br.trips,
                    br.probes))
    return out


def test_breaker_state_sequence_matches_reference():
    rng = np.random.default_rng(11)
    kinds = ("allow", "submit", "retry_after", "fail", "fail", "success")
    now, events = 0.0, []
    for _ in range(400):
        now += float(rng.exponential(2.0))
        events.append((kinds[int(rng.integers(len(kinds)))], now))
    states = set()
    for threshold, cooldown in ((1, 3.0), (2, 10.0), (3, 0.5)):
        got = _breaker_trace(CircuitBreaker(threshold, cooldown), events)
        want = _breaker_trace(jrel.CircuitBreaker(threshold, cooldown),
                              events)
        assert got == want
        states |= {e[3] for e in got}
    assert states == {"closed", "open", "half_open"}


def test_result_quality_flags_match_reference():
    for overflow in (0, 3):
        for oob in (0, 1):
            for reduced in (False, True):
                got = ResultQuality.from_counters(
                    overflow=overflow, oob=oob, reduced_ladder=reduced)
                want = jrel.ResultQuality.from_counters(
                    overflow=overflow, oob=oob, reduced_ladder=reduced)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.exact == want.exact


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(5)
    dts = rng.exponential(0.01, 300)
    dts[::17] *= 8.0                          # injected stragglers
    for factor, alpha in ((3.0, 0.1), (1.5, 0.3)):
        a = StragglerMonitor(factor=factor, alpha=alpha)
        b = JStraggler(factor=factor, alpha=alpha)
        assert [a.observe(float(d)) for d in dts] == \
            [b.observe(float(d)) for d in dts]
        assert a.ema == b.ema and a.flagged == b.flagged > 0


def _chaos(pkg_serve, params, plan_mod, plan, scenes, rng_seed):
    """The reference's chaos trace (20 % launch faults, 10 % stragglers,
    5 % poison) through one package's service; returns the outcome counts,
    the service counters and the plan's decisions."""
    rng = np.random.default_rng(rng_seed)
    cpu = {} if pkg_serve is jserve else {"device": CPU}
    svc = pkg_serve.NeighborService(pkg_serve.ServeOpts(
        retries=2, backoff_s=1e-4, breaker_n=3, max_pending=100_000), **cpu)
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
    futs, outcomes = [], {}

    def account(name):
        outcomes[name] = outcomes.get(name, 0) + 1

    with plan_mod.scoped(plan):
        now = 0.0
        for i in range(60):
            now += 0.001
            sid = ("s0", "s1")[i % 2]
            p = params[(i // 2) % 2]
            q = rng.random((int(rng.integers(4, 24)), 3)).astype(np.float32)
            try:
                futs.append(svc.submit(sid, q, p, now=now))
            except (pkg_serve.QueryError, pkg_serve.Rejected,
                    pkg_serve.CircuitOpen) as exc:
                account(type(exc).__name__)
            if i % 8 == 7:
                svc.pump(now=now, force=True)
        svc.drain(now=now)
    for f in futs:
        exc = f.exception()
        account("result" if exc is None else type(exc).__name__)
    st = svc.stats()
    counters = {k: v for k, v in st.items()
                if k not in ("registry", "breakers")}
    return outcomes, counters, st["breakers"], plan.stats()


def test_chaos_trace_outcomes_match_reference():
    rng = np.random.default_rng(0)
    scenes = {"s0": rng.random((500, 3)).astype(np.float32),
              "s1": rng.random((400, 3)).astype(np.float32)}
    spec = "launch:0.2,straggler:0.1,poison:0.05,seed:7,delay_ms:2"
    got = _chaos(tserve, (P_A, P_B), faults, FaultPlan.parse(spec), scenes,
                 1)
    want = _chaos(jserve, tuple(JParams(**dataclasses.asdict(p))
                                for p in (P_A, P_B)),
                  jrel.faults, jrel.FaultPlan.parse(spec), scenes, 1)
    assert got[0] == want[0]                  # outcome counts
    assert sum(got[0].values()) == 60 and got[0]["result"] >= 40
    for key in ("requests", "batches", "host_syncs", "retries",
                "failed_batches", "launch_failures", "query_errors",
                "resolved", "breaker_trips", "circuit_open", "expired"):
        assert got[1].get(key, 0) == want[1].get(key, 0), key
    assert got[2] == want[2]                  # breaker states
    assert got[3] == want[3]                  # decisions and injections
    assert got[3]["fired"]["launch"] > 0 and got[3]["fired"]["poison"] > 0


# ------------------------------------------------ fault hooks (serve seams)


def test_fault_hooks_noop_without_plan():
    faults.maybe_fail("launch")
    assert faults.maybe_delay() == 0.0
    q = np.zeros((4, 3), np.float32)
    assert faults.maybe_poison(q) is q
    with faults.scoped(FaultPlan(launch=1.0)):
        with pytest.raises(InjectedFault) as ei:
            faults.maybe_fail("launch")
        assert is_transient(ei.value)
        assert isinstance(ei.value, TransientFault)
    faults.maybe_fail("launch")


# ------------------------------------------ retry-after cold start


def test_retry_after_cold_start_floor():
    mb = MicroBatcher()
    floor = 0.002
    for bad in (None, float("nan"), 0.0, -1.0, float("inf")):
        assert mb._retry_after(bad, 64, floor) == floor
    assert mb._retry_after(0.010, 64, floor) == pytest.approx(0.010)
    assert mb._retry_after(1e-9, 64, floor) == floor


def test_rejected_carries_positive_retry_after_cold(rng):
    svc, _ = _svc(rng, max_pending=10)
    with pytest.raises(Rejected) as ei:
        svc.submit("s", rng.random((40, 3)).astype(np.float32), P_A)
    assert ei.value.retry_after_s > 0 and np.isfinite(ei.value.retry_after_s)


# ------------------------------------------------------- input validation


def test_validate_queries_structured_errors(rng):
    clean = rng.random((16, 3)).astype(np.float32)
    assert api.validate_queries(clean) is clean
    bad = clean.copy()
    bad[3, 1] = np.nan
    bad[7] = np.inf
    with pytest.raises(QueryError) as ei:
        api.validate_queries(bad)
    assert ei.value.reasons.get("nan", 0) >= 1
    assert ei.value.reasons.get("inf", 0) >= 1
    assert 3 in ei.value.rows and 7 in ei.value.rows
    park = clean.copy()
    park[0, 0] = 2e29
    with pytest.raises(QueryError) as ei:
        api.validate_queries(park)
    assert ei.value.reasons == {"oob": 1}
    with pytest.raises(QueryError):
        api.validate_queries(clean, lo=0.5)
    dev = torch.from_numpy(clean)
    assert api.validate_queries(dev) is dev


def _record_kernel_calls(monkeypatch):
    """Wrap the port's kernel-module entry points the query path calls
    (the fused kernel and the plain per-tile search) so every call is
    logged with its static arguments and input shapes."""
    from repro_torch.core import api as core_api
    from repro_torch.kernels import ops
    calls = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def logged(*args, **kw):
            calls.append((name, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else
                a if isinstance(a, (int, float, bool, str, tuple)) else
                type(a).__name__ for a in args), tuple(sorted(
                    (k, v) for k, v in kw.items()
                    if isinstance(v, (int, float, bool, str, tuple))))))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, logged)

    wrap(ops, "knn_tile_anchored")
    wrap(core_api, "window_tile_search")
    return calls


@pytest.mark.parametrize("pallas", [False, True])
def test_validation_env_knob_preserves_kernel_calls_and_results(
        rng, monkeypatch, pallas):
    """REPRO_VALIDATE=1 validates host rows before upload only: the
    results are bitwise equal and the port's kernel-module calls are the
    same sequence as with the knob off."""
    pts = rng.random((500, 3)).astype(np.float32)
    index = api.build_index(pts, P_A, SearchOpts(use_pallas=pallas,
                                                 query_tile=64), device=CPU)
    qs = rng.random((100, 3)).astype(np.float32)
    calls = _record_kernel_calls(monkeypatch)
    runs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("REPRO_VALIDATE", knob)
        del calls[:]
        res = api.query(index, qs)
        runs[knob] = (res, list(calls))
    assert runs["0"][1] == runs["1"][1] and runs["0"][1]
    assert {c[0] for c in runs["0"][1]} == (
        {"knn_tile_anchored"} if pallas else {"window_tile_search"})
    _assert_bitwise(runs["1"][0], runs["0"][0])


@pytest.mark.cuda
def test_validation_env_knob_preserves_device_work_on_card(monkeypatch):
    """On the card, REPRO_VALIDATE on vs off: ``api.query`` on the fused
    path gives bitwise equal results, launches the same device operations
    (counted by ``torch.profiler``) and makes the same synchronising
    calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import collections
    import warnings
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    index = api.build_index(rng.random((5000, 3)).astype(np.float32), P_A,
                            SearchOpts(use_pallas=True))
    qs = rng.random((500, 3)).astype(np.float32)
    api.query(index, qs)
    runs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("REPRO_VALIDATE", knob)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = api.query(index, qs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        ops = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
        syncs = sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        runs[knob] = (res, ops, syncs)
    assert runs["0"][1] == runs["1"][1] and runs["0"][1]
    assert runs["0"][2] == runs["1"][2]
    _assert_bitwise(runs["1"][0], runs["0"][0])


def test_poisoned_submission_fails_structured_not_launched(rng):
    svc, _ = _svc(rng)
    with faults.scoped(FaultPlan(poison=1.0)):
        with pytest.raises(QueryError):
            svc.submit("s", rng.random((8, 3)).astype(np.float32), P_A)
    st = svc.stats()
    assert st["query_errors"] == 1
    assert st.get("batches", 0) == 0 and svc.queue_depth() == 0


# ------------------------------------------------ deadlines + cancellation


def test_deadline_expired_dropped_before_launch(rng):
    svc, _ = _svc(rng)
    q = rng.random((8, 3)).astype(np.float32)
    fut = svc.submit("s", q, P_A, now=0.0, deadline_s=1.0)
    live = svc.submit("s", q, P_A, now=5.0, deadline_s=100.0)
    svc.drain(now=5.0)
    assert isinstance(fut.exception(), DeadlineExceeded)
    with pytest.raises(DeadlineExceeded):
        fut.result()
    assert live.exception() is None and live.done()
    st = svc.stats()
    assert st["expired"] == 1 and st["batches"] == 1 and st["resolved"] == 1


def test_cancelled_future_never_launches(rng):
    svc, _ = _svc(rng)
    fut = svc.submit("s", rng.random((8, 3)).astype(np.float32), P_A)
    assert fut.cancel() and fut.cancelled()
    svc.drain()
    with pytest.raises(Cancelled):
        fut.result()
    st = svc.stats()
    assert st["cancelled"] == 1 and st.get("batches", 0) == 0
    assert not fut.cancel()
    fut.set_result(object())
    with pytest.raises(Cancelled):
        fut.result()


def test_default_deadline_from_opts(rng):
    svc, _ = _svc(rng, deadline_s=1.0)
    fut = svc.submit("s", rng.random((4, 3)).astype(np.float32), P_A,
                     now=0.0)
    svc.drain(now=10.0)
    assert isinstance(fut.exception(), DeadlineExceeded)


# -------------------------------------------------------- bounded retries


def test_transient_launch_failure_retried_to_success(rng):
    svc, pts = _svc(rng, retries=2, backoff_s=1e-4)
    q = rng.random((12, 3)).astype(np.float32)
    with faults.scoped(FaultPlan(launch=1.0, budgets={"launch": 1})):
        fut = svc.submit("s", q, P_A)
        svc.drain()
    _assert_bitwise(fut.result(), _ref(pts, P_A, q))
    st = svc.stats()
    assert st["retries"] == 1 and st.get("failed_batches", 0) == 0
    assert fut.quality is not None and fut.quality.oob == 0


def test_retry_budget_exhausted_fails_fast(rng):
    svc, _ = _svc(rng, retries=1, backoff_s=1e-4)
    with faults.scoped(FaultPlan(launch=1.0)):
        fut = svc.submit("s", rng.random((6, 3)).astype(np.float32), P_A)
        svc.drain()
    assert isinstance(fut.exception(), InjectedFault)
    st = svc.stats()
    assert st["retries"] == 1 and st["failed_batches"] == 1


def _fail_at_sync(monkeypatch, site, n_fail):
    """Make the batch sync raise what the fault plan's ``site`` injects,
    through the ``maybe_fail`` seam, before it waits: a failure surfacing
    at sync time, as an asynchronous launch's does on the card."""
    wait = service_mod._wait

    def failing_wait(event, device):
        faults.maybe_fail(site)
        wait(event, device)

    monkeypatch.setattr(service_mod, "_wait", failing_wait)
    return FaultPlan(**{site: 1.0}, budgets={site: n_fail})


def test_transient_failure_at_sync_is_retried(rng, monkeypatch):
    """A transient fault that surfaces at the batch's sync takes the same
    bounded-retry path as one at dispatch: the batch is dispatched again,
    and the request resolves bitwise."""
    svc, pts = _svc(rng, retries=2, backoff_s=1e-4)
    q = rng.random((12, 3)).astype(np.float32)
    with faults.scoped(_fail_at_sync(monkeypatch, "compile", 1)):
        fut = svc.submit("s", q, P_A)
        svc.drain()
    _assert_bitwise(fut.result(), _ref(pts, P_A, q))
    st = svc.stats()
    assert st["retries"] == 1 and st.get("failed_batches", 0) == 0
    assert st["host_syncs"] == st["batches"] == 1
    assert svc.breaker_state("s") == "closed"


def test_transient_failures_at_sync_past_budget_trip_breaker(rng,
                                                            monkeypatch):
    svc, _ = _svc(rng, retries=1, backoff_s=1e-4, breaker_n=1)
    with faults.scoped(_fail_at_sync(monkeypatch, "compile", 10)):
        fut = svc.submit("s", rng.random((5, 3)).astype(np.float32), P_A,
                         now=0.0)
        svc.drain(now=0.0)
    assert isinstance(fut.exception(), InjectedFault)
    st = svc.stats()
    assert st["retries"] == 1 and st["failed_batches"] == 1
    assert st["breaker_trips"] == 1 and svc.breaker_state("s") == "open"


# -------------------------------------------------------- circuit breaker


def test_breaker_unit_state_machine():
    br = CircuitBreaker(threshold=2, cooldown_s=10.0)
    assert br.state == "closed" and br.allow(0.0)
    assert not br.record_failure(0.0)
    assert br.record_failure(0.0)
    assert br.state == "open"
    assert not br.allow(5.0) and not br.submit_allowed(5.0)
    assert br.retry_after(5.0) == pytest.approx(5.0)
    assert br.allow(10.5) and br.state == "half_open"
    assert not br.allow(10.5)
    br.record_failure(10.5)
    assert br.state == "open"
    assert not br.allow(25.0) and br.allow(31.0)
    br.record_success()
    assert br.state == "closed" and br.allow(31.0)
    assert br.trips == 2 and br.probes == 2


def test_breaker_isolates_poisoned_scene_and_recovers(rng):
    pts0 = rng.random((500, 3)).astype(np.float32)
    pts1 = rng.random((400, 3)).astype(np.float32)
    svc = NeighborService(ServeOpts(retries=0, breaker_n=2,
                                    breaker_cooldown_s=10.0), device=CPU)
    svc.register_scene("s0", pts0)
    svc.register_scene("s1", pts1)
    q = rng.random((8, 3)).astype(np.float32)
    ref1 = _ref(pts1, P_A, q)
    with faults.scoped(FaultPlan(launch=1.0, scene="s0")):
        for _ in range(2):
            bad = svc.submit("s0", q, P_A, now=0.0)
            good = svc.submit("s1", q, P_A, now=0.0)
            svc.drain(now=0.0)
            assert isinstance(bad.exception(), InjectedFault)
            _assert_bitwise(good.result(), ref1)
        assert svc.breaker_state("s0") == "open"
        assert svc.stats()["breaker_trips"] == 1
        with pytest.raises(CircuitOpen) as ei:
            svc.submit("s0", q, P_A, now=1.0)
        assert ei.value.retry_after_s > 0
        good = svc.submit("s1", q, P_A, now=1.0)
        svc.drain(now=1.0)
        _assert_bitwise(good.result(), ref1)
        probe = svc.submit("s0", q, P_A, now=11.0)
        svc.drain(now=11.0)
        assert isinstance(probe.exception(), InjectedFault)
        assert svc.breaker_state("s0") == "open"
        with pytest.raises(CircuitOpen):
            svc.submit("s0", q, P_A, now=12.0)
    probe = svc.submit("s0", q, P_A, now=32.0)
    svc.drain(now=32.0)
    _assert_bitwise(probe.result(), _ref(pts0, P_A, q))
    assert svc.breaker_state("s0") == "closed"


def test_breaker_open_fails_queued_batch_at_drain(rng):
    svc, _ = _svc(rng, retries=0, breaker_n=1, breaker_cooldown_s=100.0)
    q = rng.random((4, 3)).astype(np.float32)
    with faults.scoped(FaultPlan(launch=1.0, scene="s")):
        bad = svc.submit("s", q, P_A, now=0.0)
        queued = svc.submit("s", q, P_B, now=0.0)
        svc.drain(now=0.0)
    assert isinstance(bad.exception(), InjectedFault)
    assert svc.breaker_state("s") == "open"
    assert isinstance(queued.exception(), CircuitOpen)
    assert svc.stats()["circuit_open"] >= 1


# ------------------------------------------------------ pump containment


def test_sync_failure_fails_futures_not_hangs(rng, monkeypatch):
    svc, _ = _svc(rng)
    fut = svc.submit("s", rng.random((4, 3)).astype(np.float32), P_A)

    def boom(flight, now_fn=time.monotonic):
        raise RuntimeError("device lost")

    monkeypatch.setattr(svc, "_finish", boom)
    svc.drain()
    assert isinstance(fut.exception(), RuntimeError)
    assert svc.stats()["failed_batches"] == 1


def test_pump_crash_fails_taken_requests(rng, monkeypatch):
    svc, _ = _svc(rng)
    fut = svc.submit("s", rng.random((4, 3)).astype(np.float32), P_A)
    monkeypatch.setattr(
        svc, "_run_batch",
        lambda *a, **kw: (_ for _ in ()).throw(MemoryError("oom")))
    with pytest.raises(MemoryError):
        svc.drain()
    assert isinstance(fut.exception(), MemoryError)
    assert svc.stats()["pump_crashes"] == 1


def test_background_pump_survives_crash(rng):
    svc, _ = _svc(rng, max_wait_s=0.005)
    orig = svc._batcher.take
    state = {"crashed": False}

    def flaky_take(*args, **kwargs):
        if not state["crashed"] and not svc._batcher.empty():
            state["crashed"] = True
            raise RuntimeError("transient scheduler bug")
        return orig(*args, **kwargs)

    svc._batcher.take = flaky_take
    svc.start(poll_s=0.002)
    try:
        fut = svc.submit("s", rng.random((6, 3)).astype(np.float32), P_A)
        assert fut.result(timeout=30.0).indices.shape == (6, P_A.k)
    finally:
        svc.stop()
    assert state["crashed"]
    st = svc.stats()
    assert st["pump_restarts"] >= 1 and st["pump_crashes"] >= 1


def test_straggler_monitor_wired_into_pump(rng):
    svc, _ = _svc(rng)
    q = rng.random((16, 3)).astype(np.float32)
    svc.registry.get("s").variant(P_A).warm(16)
    for _ in range(4):
        svc.submit("s", q, P_A)
        svc.drain()
    # the injected delay dwarfs the steady state even on a loaded machine
    delay = max(0.25, 10.0 * svc._straggler.ema)
    with faults.scoped(FaultPlan(straggler=1.0, delay_s=delay)):
        fut = svc.submit("s", q, P_A)
        svc.drain()
    assert fut.done() and fut.exception() is None
    assert svc.stats()["stragglers"] >= 1
    assert svc._straggler.ema is not None


# --------------------------------------------------- graceful degradation


def test_overload_degrades_with_quality_flag(rng):
    svc, pts = _svc(rng, max_pending=50, degrade=True, degrade_hard=2.0)
    q1 = rng.random((40, 3)).astype(np.float32)
    q2 = rng.random((40, 3)).astype(np.float32)
    f1 = svc.submit("s", q1, P_A)
    f2 = svc.submit("s", q2, P_A)
    with pytest.raises(Rejected):
        svc.submit("s", q1, P_A)
    assert svc.stats()["degraded_admissions"] == 1
    svc.drain()
    assert f1.quality is not None and not f1.quality.reduced_ladder
    assert f2.quality.degraded and f2.quality.reduced_ladder
    assert svc.stats()["degraded_responses"] == 1
    _assert_bitwise(f1.result(), _ref(pts, P_A, q1))
    _assert_bitwise(f2.result(), _ref(pts, P_A, q2, SearchOpts(w_ladder=(1,))))


def test_result_quality_from_counters():
    assert ResultQuality.from_counters().exact
    rq = ResultQuality.from_counters(overflow=3, oob=1, reduced_ladder=True)
    assert rq.degraded and not rq.exact
    assert rq.overflow == 3 and rq.oob == 1 and rq.reduced_ladder
    assert "overflow" in rq.reason and "ladder" in rq.reason


def test_session_quality_counters_reach_responses(rng):
    pts = rng.random((400, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    sess.step(pts)
    svc = NeighborService(device=CPU)
    svc.register_session("sim", sess)
    fut = svc.submit("sim", rng.random((8, 3)).astype(np.float32), P_A)
    svc.drain()
    assert fut.quality.overflow == sess.report.overflow
    assert fut.quality.oob == sess.report.oob


# ------------------------------------------------- session step x drain


def test_session_step_and_drain_interleave_bitwise(rng):
    pts = rng.random((300, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    sess.step(pts)
    svc = NeighborService(device=CPU)
    svc.register_session("sim", sess)
    cur = pts
    for _ in range(100):
        cur = np.clip(cur + rng.normal(0, 0.001, cur.shape), 0,
                      1).astype(np.float32)
        sess.step(cur)
        q = rng.random((8, 3)).astype(np.float32)
        fut = svc.submit("sim", q, P_A)
        svc.drain()
        _assert_bitwise(fut.result(timeout=30.0), api.query(sess.index, q))
    assert svc.queue_depth() == 0


def test_session_step_concurrent_with_background_pump(rng):
    pts = rng.random((300, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    sess.step(pts)
    svc = NeighborService(ServeOpts(max_wait_s=0.002), device=CPU)
    svc.register_session("sim", sess)
    stop, steps = threading.Event(), {"n": 0}

    def stepper():
        cur, srng = pts, np.random.default_rng(42)
        while not stop.is_set() and steps["n"] < 100:
            cur = np.clip(cur + srng.normal(0, 0.001, cur.shape), 0,
                          1).astype(np.float32)
            sess.step(cur)
            steps["n"] += 1

    th = threading.Thread(target=stepper)
    svc.start(poll_s=0.001)
    th.start()
    try:
        futs = [svc.submit("sim", rng.random((6, 3)).astype(np.float32),
                           P_A) for _ in range(30)]
        for f in futs:
            f.result(timeout=60.0)
    finally:
        stop.set()
        th.join(timeout=60.0)
        svc.stop()
    assert not th.is_alive() and steps["n"] > 0
    q = rng.random((8, 3)).astype(np.float32)
    fut = svc.submit("sim", q, P_A)
    svc.drain()
    _assert_bitwise(fut.result(), api.query(sess.index, q))


# ------------------------------------------------------- the chaos gate


def test_chaos_trace_zero_hung_futures(rng):
    scenes = {"s0": rng.random((500, 3)).astype(np.float32),
              "s1": rng.random((400, 3)).astype(np.float32)}
    svc = NeighborService(ServeOpts(retries=2, backoff_s=1e-4, breaker_n=3,
                                    max_pending=100_000), device=CPU)
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
    plan = FaultPlan(launch=0.2, straggler=0.1, poison=0.05, seed=7,
                     delay_s=0.002)
    submitted, outcomes = [], {}
    with faults.scoped(plan):
        now = 0.0
        for i in range(60):
            now += 0.001
            sid = ("s0", "s1")[i % 2]
            params = (P_A, P_B)[(i // 2) % 2]
            q = rng.random((int(rng.integers(4, 24)), 3)).astype(np.float32)
            try:
                submitted.append(
                    (sid, params, q, svc.submit(sid, q, params, now=now)))
            except (QueryError, Rejected, CircuitOpen) as exc:
                outcomes[type(exc).__name__] = \
                    outcomes.get(type(exc).__name__, 0) + 1
            if i % 8 == 7:
                svc.pump(now=now, force=True)
        svc.drain(now=now)
    refs, hung = {}, 0
    for sid, params, q, fut in submitted:
        try:
            res = fut.result(timeout=30.0)
        except TimeoutError:
            hung += 1
            continue
        except (DeadlineExceeded, QueryError, CircuitOpen,
                InjectedFault) as exc:
            outcomes[type(exc).__name__] = \
                outcomes.get(type(exc).__name__, 0) + 1
            continue
        outcomes["result"] = outcomes.get("result", 0) + 1
        if not fut.quality.reduced_ladder:
            if (sid, params) not in refs:
                refs[(sid, params)] = api.build_index(scenes[sid], params,
                                                      device=CPU)
            _assert_bitwise(res, api.query(refs[(sid, params)], q))
    assert hung == 0
    assert sum(outcomes.values()) == 60
    assert outcomes.get("result", 0) >= 40
    fired = plan.stats()["fired"]
    assert fired["launch"] > 0 and fired["poison"] > 0
    assert svc.queue_depth() == 0


def test_no_faults_no_behavior_change(rng):
    svc, pts = _svc(rng)
    q = rng.random((16, 3)).astype(np.float32)
    futs = [svc.submit("s", q, P_A) for _ in range(5)]
    svc.drain()
    st = svc.stats()
    assert st["host_syncs"] == st["batches"]
    for key in ("retries", "failed_batches", "expired", "cancelled",
                "query_errors", "circuit_open", "pump_crashes"):
        assert st.get(key, 0) == 0, key
    ref = _ref(pts, P_A, q)
    for f in futs:
        _assert_bitwise(f.result(), ref)
        assert f.quality.exact and not f.quality.reduced_ladder


def test_serve_cli_chaos_gate_on_cpu():
    """``launch/serve.py --trace short`` under a seeded fault plan exits 0:
    every request accounted for, no future hung."""
    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_FAULTS="launch:0.2,straggler:0.1,poison:0.05,seed:7")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--trace",
         "short", "--device", CPU], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "(accounted 64/64)" in proc.stdout
    assert "HUNG" not in proc.stdout and "chaos plan" in proc.stdout
