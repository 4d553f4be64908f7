"""The port's neighbor-query service (``repro_torch.serve``) against the JAX
reference (``repro.serve``), and the reference's serving contract tests
(``tests/test_serve.py``) on the port.

Parity: the same seeded numpy scenes and request trace go through
``repro.serve.NeighborService`` and ``repro_torch.serve.NeighborService``.
The batch reports (drain order, scene, signature, request seqs, ``nq``,
``pad_n``) must be equal; per request, counts exactly, ``d2`` within
atol 1e-6 (the rule of ``test_torch_api.py``) and indices except between
distances that tie within 1e-6. The port's own contract tests compare the
service with the port's ``api.query`` bitwise, as the reference's do.

Also here: the session step lock (a stepper thread and the background
pump on a session whose re-bin is donated), the entry points' default
device, the ``launch/serve.py`` smoke, and a ``cuda`` test of the service
on the card.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import SearchOpts as JOpts
from repro.core import SearchParams as JParams
import repro_torch.api as api
from repro_torch import obs
from repro_torch.core import (SearchOpts, SearchParams, SessionOpts,
                              SimulationSession)
from repro_torch.serve import (NeighborService, Rejected, SceneRegistry,
                               ServeOpts)

SRC = Path(__file__).resolve().parents[1] / "src"
D2_ATOL = 1e-6
P_A = SearchParams(radius=0.11, k=8, knn_window="exact")
P_B = SearchParams(radius=0.15, k=4, knn_window="exact")
CPU = "cpu"


@pytest.fixture(autouse=True)
def clean_obs():
    obs.reset()
    yield
    obs.configure()
    obs.reset()


def _jparams(p: SearchParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


def _scenes(rng, sizes=(1100, 800)):
    return {f"s{i}": rng.random((n, 3)).astype(np.float32)
            for i, n in enumerate(sizes)}


def _trace(rng, scene_ids, n_requests, params=(P_A, P_B), qmin=5,
           qmax=60):
    out = []
    for _ in range(n_requests):
        sid = scene_ids[int(rng.integers(len(scene_ids)))]
        p = params[int(rng.integers(len(params)))]
        q = rng.random((int(rng.integers(qmin, qmax + 1)), 3)) \
            .astype(np.float32)
        out.append((sid, p, q))
    return out


def _assert_bitwise(got, ref):
    """Port against port: equal indices and counts, ``d2`` bitwise with
    inf masked."""
    assert torch.equal(got.indices, ref.indices)
    assert torch.equal(got.counts, ref.counts)
    da = torch.where(torch.isinf(got.distances2), -1.0, got.distances2)
    db = torch.where(torch.isinf(ref.distances2), -1.0, ref.distances2)
    assert torch.equal(da, db)


def _assert_same_result(jres, tres):
    """Reference against port: counts and inf masks exact, ``d2`` within
    ``D2_ATOL``, indices equal except between tied distances."""
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


def _report_key(r):
    return (r.scene_id, dataclasses.astuple(r.params), r.seqs, r.nq, r.pad_n)


# ------------------------------------------------- parity with the reference


def _serve_both(scenes, trace, *, jopts=JOpts(), topts=SearchOpts(),
                **serve_kw):
    jsvc = jserve.NeighborService(jserve.ServeOpts(**serve_kw))
    tsvc = NeighborService(ServeOpts(**serve_kw), device=CPU)
    for sid, pts in scenes.items():
        jsvc.register_scene(sid, pts)
        tsvc.register_scene(sid, pts)
    jf = [jsvc.submit(sid, q, _jparams(p), jopts) for sid, p, q in trace]
    tf = [tsvc.submit(sid, q, p, topts) for sid, p, q in trace]
    return (jsvc, jsvc.drain(), jf), (tsvc, tsvc.drain(), tf)


def test_serve_matches_reference_on_mixed_trace(rng):
    """A mixed multi-scene, mixed-signature trace: identical batch reports
    (drain order, keys, nq, pad_n, request seqs), identical service
    counters, and per-request results equal under the parity rules."""
    scenes = _scenes(rng)
    trace = _trace(rng, list(scenes), 28)
    (jsvc, jrep, jf), (tsvc, trep, tf) = _serve_both(
        scenes, trace, max_batch=512, max_pending=100_000)
    assert [_report_key(r) for r in trep] == [_report_key(r) for r in jrep]
    assert len(trep) < len(trace)                # coalescing happened
    js, ts = jsvc.stats(), tsvc.stats()
    for key in ("requests", "query_rows", "batches", "host_syncs",
                "resolved", "queue_depth", "queue_queries"):
        assert ts[key] == js[key], key
    for a, b in zip(jf, tf):
        _assert_same_result(a.result(timeout=30), b.result(timeout=30))
        assert dataclasses.asdict(b.quality) == dataclasses.asdict(a.quality)


def test_serve_fused_path_matches_reference_interpret(rng):
    """``use_pallas=True`` on both sides, kept tiny: the reference's Pallas
    kernel in interpret mode, the port's kernel through its plain version
    on the CPU."""
    scenes = {"s0": rng.random((300, 3)).astype(np.float32)}
    trace = _trace(rng, ["s0"], 3, params=(P_A,), qmin=1, qmax=12)
    (_, jrep, jf), (_, trep, tf) = _serve_both(
        scenes, trace, jopts=JOpts(use_pallas=True, query_tile=32),
        topts=SearchOpts(use_pallas=True, query_tile=32))
    assert [_report_key(r) for r in trep] == [_report_key(r) for r in jrep]
    for a, b in zip(jf, tf):
        _assert_same_result(a.result(timeout=60), b.result(timeout=60))


def test_session_backed_scene_matches_reference(rng):
    """A registered session in both packages, stepped through the same
    frames: each drained result agrees, and the quality flags carry the
    same session counters."""
    import repro.core as jc
    pts = rng.random((500, 3)).astype(np.float32)
    jsess = jc.SimulationSession(pts, _jparams(P_A))
    tsess = SimulationSession(pts, P_A, device=CPU)
    jsvc, tsvc = jserve.NeighborService(), NeighborService(device=CPU)
    jsvc.register_session("sim", jsess)
    tsvc.register_session("sim", tsess)
    cur = pts
    for _ in range(3):
        cur = np.clip(cur + rng.normal(0, 0.003, cur.shape), 0,
                      1).astype(np.float32)
        jsess.step(cur)
        tsess.step(cur)
        q = rng.random((int(rng.integers(1, 64)), 3)).astype(np.float32)
        jfut, tfut = jsvc.submit("sim", q, _jparams(P_A)), \
            tsvc.submit("sim", q, P_A)
        assert ([_report_key(r) for r in tsvc.drain()]
                == [_report_key(r) for r in jsvc.drain()])
        _assert_same_result(jfut.result(timeout=30), tfut.result(timeout=30))
        assert dataclasses.asdict(tfut.quality) == \
            dataclasses.asdict(jfut.quality)


# ------------------------------------------------ parity + one-sync contract


def test_serve_bitwise_parity_and_one_sync_per_batch(rng):
    """Every request of a mixed trace is bitwise what the port's
    ``api.query`` returns for it alone, with one host sync per drained
    batch and real micro-batching."""
    scenes = _scenes(rng)
    svc = NeighborService(ServeOpts(max_batch=512, max_pending=100_000),
                          device=CPU)
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
    trace = _trace(rng, list(scenes), 28)
    futures = [(sid, p, q, svc.submit(sid, q, p)) for sid, p, q in trace]
    reports = svc.drain()
    st = svc.stats()
    assert st["host_syncs"] == st["batches"] == len(reports)
    assert len(reports) < len(futures)
    assert st["resolved"] == len(futures)
    assert st["queue_depth"] == 0
    refs = {}
    for sid, p, q, fut in futures:
        if (sid, p) not in refs:
            refs[(sid, p)] = api.build_index(scenes[sid], p, device=CPU)
        _assert_bitwise(fut.result(timeout=30), api.query(refs[(sid, p)], q))


def test_session_backed_scene_serves_current_frame(rng):
    pts = rng.random((600, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    sess.step(pts)
    sess.step(np.clip(pts + rng.normal(0, 0.004, pts.shape), 0,
                      1).astype(np.float32))
    svc = NeighborService(device=CPU)
    svc.register_session("sim", sess)
    q = rng.random((40, 3)).astype(np.float32)
    fut = svc.submit("sim", q, P_A)
    svc.drain()
    _assert_bitwise(fut.result(timeout=30), api.query(sess.index, q))
    with pytest.raises(ValueError):
        svc.registry.resolve("sim", P_B)


# ------------------------------------------------------- registry residency


def test_registry_lru_eviction_and_readmission_rewarm(rng):
    scenes = _scenes(rng, sizes=(700, 500))
    evicted = []
    svc = NeighborService(ServeOpts(scenes=1), device=CPU)
    svc.registry.on_evict(lambda sid, rec: evicted.append(sid))
    svc.register_scene("s0", scenes["s0"])
    q = rng.random((24, 3)).astype(np.float32)
    fut = svc.submit("s0", q, P_A)
    svc.drain()
    v0 = svc.registry.get("s0").variant(P_A)
    assert v0.compiled_programs() >= 1           # bucket served
    ref = api.query(api.build_index(scenes["s0"], P_A, device=CPU), q)
    _assert_bitwise(fut.result(), ref)

    svc.register_scene("s1", scenes["s1"])       # capacity 1 -> evicts s0
    assert evicted == ["s0"]
    assert "s0" not in svc.registry and "s1" in svc.registry
    assert v0.fn is None                         # state released
    assert v0.searcher.executor.stats()["plan_cache_entries"] == 0
    with pytest.raises(KeyError):
        svc.submit("s0", q, P_A)

    svc.register_scene("s0", scenes["s0"])       # readmission re-warms
    v1 = svc.registry.get("s0").variant(P_A)
    assert v1 is not v0 and v1.compiled_programs() == 0
    fut2 = svc.submit("s0", q, P_A)
    svc.drain()
    assert v1.compiled_programs() >= 1
    _assert_bitwise(fut2.result(), ref)


def test_scene_evicted_between_admission_and_drain_fails_futures(rng):
    scenes = _scenes(rng, sizes=(600, 500, 400))
    svc = NeighborService(ServeOpts(scenes=2), device=CPU)
    svc.register_scene("s0", scenes["s0"])
    svc.register_scene("s1", scenes["s1"])
    q = rng.random((16, 3)).astype(np.float32)
    fut_dead = svc.submit("s0", q, P_A)
    fut_live = svc.submit("s1", q, P_A)
    svc.register_scene("s2", scenes["s2"])       # evicts LRU = s0
    reports = svc.drain()
    assert isinstance(fut_dead.exception(), KeyError)
    assert fut_live.exception() is None
    _assert_bitwise(fut_live.result(), api.query(
        api.build_index(scenes["s1"], P_A, device=CPU), q))
    assert {r.scene_id for r in reports} == {"s1"}
    assert svc.stats()["failed_batches"] == 1
    assert svc.queue_depth() == 0


def test_registry_warm_on_register(rng):
    svc = NeighborService(device=CPU)
    svc.register_scene("s", rng.random((500, 3)).astype(np.float32),
                       warm=(P_A, 64))
    v = svc.registry.get("s").variant(P_A)
    assert v.compiled_programs() == 1
    fut = svc.submit("s", rng.random((20, 3)).astype(np.float32), P_A)
    svc.drain()
    assert fut.done() and v.compiled_programs() == 1


def test_first_launch_of_a_bucket_is_traced_as_compile(rng):
    """The bucket's first launch stands where the reference's compile of
    a new serve program stood: one ``compile`` span, then none."""
    obs.configure(mode="log")
    svc = NeighborService(device=CPU)
    svc.register_scene("s", rng.random((500, 3)).astype(np.float32))
    for _ in range(2):
        svc.submit("s", rng.random((20, 3)).astype(np.float32), P_A)
        svc.drain()
    assert sum(r["name"] == "compile" for r in obs.recent_spans()) == 1


# ------------------------------------------------------------- backpressure


def test_backpressure_rejects_past_high_water_then_drains(rng):
    svc = NeighborService(ServeOpts(max_pending=100, max_batch=256),
                          device=CPU)
    svc.register_scene("s", rng.random((600, 3)).astype(np.float32))
    q = rng.random((40, 3)).astype(np.float32)
    accepted = [svc.submit("s", q, P_A), svc.submit("s", q, P_A)]
    with pytest.raises(Rejected) as exc_info:
        svc.submit("s", q, P_A)                  # 120 pending > 100
    assert exc_info.value.retry_after_s > 0
    assert svc.stats()["rejected"] == 1
    svc.drain()
    assert svc.queue_depth() == 0
    fut = svc.submit("s", q, P_A)
    svc.drain()
    assert fut.done() and all(f.done() for f in accepted)


# --------------------------------------------------------------- scheduling


def test_deterministic_drain_order_under_seeded_trace():
    def run(pipeline):
        rng = np.random.default_rng(7)
        scenes = _scenes(rng)
        svc = NeighborService(ServeOpts(max_batch=256, pipeline=pipeline,
                                        max_pending=100_000), device=CPU)
        for sid, pts in scenes.items():
            svc.register_scene(sid, pts)
        for sid, p, q in _trace(rng, list(scenes), 30):
            svc.submit(sid, q, p)
        return [_report_key(r) for r in svc.drain()]

    first = run(pipeline=1)
    assert first == run(pipeline=1) == run(pipeline=0) == run(pipeline=3)
    assert len(first) > 1


def test_bucket_deadline_and_max_batch(rng):
    svc = NeighborService(ServeOpts(max_batch=64, max_wait_s=10.0),
                          device=CPU)
    svc.register_scene("s", rng.random((500, 3)).astype(np.float32))
    q = rng.random((8, 3)).astype(np.float32)
    svc.submit("s", q, P_A, now=0.0)
    assert svc.pump(now=0.5) == []               # not full, not due
    assert svc.queue_depth() == 1
    reports = svc.pump(now=10.5)                 # past the deadline
    assert len(reports) == 1 and svc.queue_depth() == 0
    for _ in range(10):
        svc.submit("s", q, P_A, now=20.0)
    reports = svc.pump(now=20.0)
    assert len(reports) >= 1 and all(r.nq <= 64 for r in reports)
    assert sum(len(r.seqs) for r in reports) == 8    # 2 of 10 not yet due
    assert svc.queue_depth() == 2
    svc.drain()


def test_per_scene_fairness_no_starvation(rng):
    scenes = _scenes(rng, sizes=(700, 500))
    svc = NeighborService(ServeOpts(max_batch=128, max_pending=100_000),
                          device=CPU)
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
    hot = rng.random((64, 3)).astype(np.float32)
    for _ in range(6):
        svc.submit("s0", hot, P_A)
    cold_fut = svc.submit("s1", rng.random((16, 3)).astype(np.float32),
                          P_A)
    reports = svc.drain()
    cold_pos = next(i for i, r in enumerate(reports) if r.scene_id == "s1")
    assert cold_pos <= 1
    assert cold_fut.done()
    assert sum(r.scene_id == "s0" for r in reports) >= 3


def test_standalone_registry_capacity_validation():
    with pytest.raises(ValueError):
        SceneRegistry(capacity=0, device=CPU)
    with pytest.raises(ValueError):
        ServeOpts(max_batch=0)
    with pytest.raises(ValueError):
        ServeOpts(pipeline=-1)


def test_background_pump_resolves_futures(rng):
    svc = NeighborService(ServeOpts(max_wait_s=0.01), device=CPU)
    svc.register_scene("s", rng.random((500, 3)).astype(np.float32),
                       warm=(P_A, 256))
    svc.start(poll_s=0.005)
    try:
        fut = svc.submit("s", rng.random((12, 3)).astype(np.float32), P_A)
        assert fut.result(timeout=30.0).indices.shape == (12, P_A.k)
    finally:
        svc.stop()
    assert svc.queue_depth() == 0


def test_staged_batch_is_edge_padded_and_split_into_views(rng):
    """Staging concatenates the requests and repeats the last real row up
    to the bucket; the split results are views of the batch's tensors."""
    from repro_torch.serve import Request, split_result, stage_batch
    qs = [rng.random((n, 3)).astype(np.float32) for n in (3, 5)]
    reqs = [Request(seq=i, scene_id="s", params=P_A, opts=SearchOpts(),
                    queries=q, future=None, t_submit=0.0, t_real=0.0,
                    t_perf=0.0) for i, q in enumerate(qs)]
    st = stage_batch(("s", P_A, SearchOpts()), reqs, 16, torch.device(CPU))
    assert st.nq == 8 and st.pad_n == 16 and st.offsets == [0, 3, 8]
    np.testing.assert_array_equal(st.queries[:8].numpy(),
                                  np.concatenate(qs))
    np.testing.assert_array_equal(st.queries[8:].numpy(),
                                  np.broadcast_to(qs[1][-1], (8, 3)))
    res = api.query(api.build_index(rng.random((200, 3)).astype(np.float32),
                                    P_A, device=CPU), st.queries)
    parts = split_result(st, res)
    assert [p.indices.shape[0] for p in parts] == [3, 5]
    assert parts[1].distances2.data_ptr() == \
        res.distances2[3:].data_ptr()


# ------------------------------------------------- the session step lock


def _frame_snapshot(index):
    """A copy of a session frame that a later donated re-bin cannot
    overwrite (only the dense grid is written in place)."""
    return dataclasses.replace(index, grid=dataclasses.replace(
        index.grid, dense=index.grid.dense.clone()))


def test_session_step_lock_with_donated_rebin_and_background_pump(rng):
    """A stepper thread re-bins a session in place (``donate_grid=True``)
    while the background pump drains queries against it, one request at a
    time. No future hangs, every drained result is bitwise what
    ``api.query`` returns on one whole frame of the session, and the final
    drain equals ``api.query`` on the current frame. Without the lock in
    the service's dispatch this fails: a batch reads one frame's points
    and, through the donated storage, the next frame's grid."""
    pts = rng.random((300, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, sopts=SessionOpts(donate_grid=True),
                             device=CPU)
    sess.step(pts)
    assert sess._donate
    frames = [_frame_snapshot(sess.index)]
    svc = NeighborService(ServeOpts(max_wait_s=0.002), device=CPU)
    svc.register_session("sim", sess)
    stop, steps = threading.Event(), {"n": 0}

    def stepper():
        # each frame relabels the particles (a permutation), so a batch
        # that mixed two frames' points and grid would match neither
        srng = np.random.default_rng(42)
        while not stop.is_set() and steps["n"] < 200:
            sess.step(pts[srng.permutation(len(pts))])
            with sess.lock:
                frames.append(_frame_snapshot(sess.index))
            steps["n"] += 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=stepper)
    svc.start(poll_s=0.001)
    th.start()
    try:
        # one request at a time, so each drains in its own batch while
        # the stepper keeps re-binning
        qs = [rng.random((6, 3)).astype(np.float32) for _ in range(40)]
        results = [svc.submit("sim", q, P_A).result(timeout=60.0)
                   for q in qs]
    finally:
        stop.set()
        th.join(timeout=60.0)
        svc.stop()
        sys.setswitchinterval(switch)
    assert not th.is_alive() and steps["n"] > 0
    cat = np.concatenate(qs)
    per_frame = [api.query(f, cat) for f in frames]
    for i, res in enumerate(results):
        rows = slice(6 * i, 6 * i + 6)

        def same(ref):
            return (torch.equal(res.indices, ref.indices[rows])
                    and torch.equal(res.counts, ref.counts[rows])
                    and torch.equal(res.distances2, ref.distances2[rows]))

        assert any(same(ref) for ref in per_frame), i
    q = rng.random((8, 3)).astype(np.float32)
    fut = svc.submit("sim", q, P_A)
    svc.drain()
    _assert_bitwise(fut.result(), api.query(sess.index, q))


def test_session_step_holds_its_lock(rng):
    """``step`` takes the session's lock: it waits while another holder
    (a drain reading the frame) has it."""
    pts = rng.random((200, 3)).astype(np.float32)
    sess = SimulationSession(pts, P_A, device=CPU)
    done = threading.Event()
    with sess.lock:
        th = threading.Thread(target=lambda: (sess.step(pts), done.set()))
        th.start()
        assert not done.wait(0.3)
    th.join(timeout=60.0)
    assert not th.is_alive() and done.is_set()


# ----------------------------------------------- default device, CLI smoke


def test_service_and_registry_default_to_cuda():
    """Without a CUDA device and without ``device="cpu"`` the service and
    the registry raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        NeighborService()
    with pytest.raises(RuntimeError, match="CUDA"):
        SceneRegistry()
    assert NeighborService(device=CPU).registry.device.type == "cpu"


def _run_cli(module, *args, env=None):
    e = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    e.update(PYTHONPATH=str(SRC), **(env or {}))
    return subprocess.run([sys.executable, "-m", module, *args], env=e,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_smoke_on_cpu():
    proc = _run_cli("repro_torch.launch.serve", "--smoke", "--device", CPU)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "outcomes result=64 (accounted 64/64)" in proc.stdout
    bad = _run_cli("repro_torch.launch.serve", "--smoke")
    if not torch.cuda.is_available():
        assert bad.returncode != 0 and "CUDA" in bad.stderr


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
def test_service_on_card_fused_one_sync_per_batch():
    """On the card: a mixed trace through the fused path, each request
    bitwise what ``api.query`` returns for it alone, one
    ``knn_tile_anchored`` launch and one blocking sync per drained batch
    (counted by ``torch.cuda.set_sync_debug_mode``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import warnings
    from repro_torch.kernels import knn_tile as tknn
    rng = np.random.default_rng(3)
    opts = SearchOpts(use_pallas=True)
    scenes = _scenes(rng, sizes=(4000, 3000))
    svc = NeighborService(ServeOpts(max_batch=512, max_pending=100_000))
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
        for p in (P_A, P_B):
            v = svc.registry.get(sid).variant(p, opts)
            for n in (256, 512):
                v.warm(n)
            v.quality_counters()
    trace = _trace(rng, list(scenes), 40)
    torch.cuda.synchronize()
    k0 = tknn.knn_tile_anchored.launches
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            futs = [svc.submit(sid, q, p, opts) for sid, p, q in trace]
            reports = svc.drain()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    st = svc.stats()
    assert len(syncs) == st["host_syncs"] == st["batches"] == len(reports)
    assert tknn.knn_tile_anchored.launches - k0 == len(reports)
    assert len(reports) < len(trace)
    for (sid, p, q), f in zip(trace, futs):
        variant = svc.registry.resolve(sid, p, opts)
        _assert_bitwise(f.result(timeout=60), api.query(variant.index, q))
