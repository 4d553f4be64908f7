"""Neighbor-search serving launcher: a synthetic multi-tenant request trace
against ``repro_torch.serve.NeighborService`` (the reference's
``launch/serve.py`` on PyTorch, with its flags and defaults plus
``--device``).

Generates a seeded trace — N scenes, Poisson arrivals, per-request scene
ids drawn from a skewed tenant mix, mixed radii/K signatures, variable
query counts — drives it through the admission queue/micro-batcher, and
reports QPS, batch occupancy, and end-to-end p50/p95/p99 latency from the
unified telemetry registry.

  PYTHONPATH=src python -m repro_torch.launch.serve --scenes 3 --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --lm --smoke   # LM demo

The service runs on ``--device`` (default ``cuda``; without a card it
raises, and the CPU runs only with ``--device cpu``). On the card requests
are served on the fused path, ``SearchOpts(use_pallas=True)``: one
``knn_tile_anchored`` launch per drained batch. On the CPU they take the
plain path (the reference's default; the kernel's plain version models the
card's work split and is about 100x slower there). ``--lm`` delegates to
``launch/serve_lm.py`` with the same ``--device``.

The trace is deterministic per ``--seed`` (arrival process included), so
two runs drain identical batch sequences — the property the serve tests
pin down.

**Chaos mode**: with ``REPRO_FAULTS`` set (e.g.
``REPRO_FAULTS=launch:0.2,straggler:0.1``) the same trace runs under
seeded fault injection. The launcher then acts as the reliability gate: it
accounts every submitted request to exactly one terminal outcome
({result, DeadlineExceeded, QueryError, Rejected, CircuitOpen, ...}),
prints the outcome and injected-fault tables, and exits nonzero if ANY
future hangs (fails to resolve within the timeout) or goes unaccounted.

  REPRO_FAULTS=launch:0.2,straggler:0.1 \\
      PYTHONPATH=src python -m repro_torch.launch.serve --trace short

``--trace short|full`` selects a canned trace size (short == the CI chaos
smoke); ``--deadline-ms`` arms per-request server-side deadlines on the
simulated arrival clock.

**Per-tenant SLOs**: the launcher always prints the
per-tenant outcome table from ``repro_torch.obs.slo`` (every terminal outcome
is attributed by the service), and with a target armed — ``--slo
'latency_ms:250,objective:0.9'`` or the ``REPRO_SLO`` knob — it exits
nonzero if any tenant's attainment on the seeded trace is below its
objective. Hung futures additionally dump the flight recorder
(``REPRO_FLIGHT=1``) before the gate fails.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_trace(args):
    """The seeded synthetic trace: (arrival_dt_s, scene_id, params,
    queries) per request, plus the per-scene point clouds."""
    import numpy as np

    from repro_torch.core import SearchParams

    rng = np.random.default_rng(args.seed)
    scenes = {
        f"scene{i}": rng.random((args.points, 3)).astype(np.float32)
        for i in range(args.scenes)
    }
    # mixed search signatures: the micro-batcher buckets by these
    signatures = [
        SearchParams(radius=0.09, k=8, knn_window="exact"),
        SearchParams(radius=0.13, k=4, knn_window="exact"),
        SearchParams(radius=0.11, k=16, knn_window="exact"),
    ][: max(1, args.signatures)]
    # skewed tenant popularity (hot first scene), normalized
    weights = np.array([1.0 / (i + 1) for i in range(args.scenes)])
    weights /= weights.sum()
    scene_ids = list(scenes)
    trace = []
    for _ in range(args.requests):
        dt = float(rng.exponential(1.0 / args.rate))
        sid = scene_ids[int(rng.choice(args.scenes, p=weights))]
        params = signatures[int(rng.integers(len(signatures)))]
        nq = int(rng.integers(args.qmin, args.qmax + 1))
        q = rng.random((nq, 3)).astype(np.float32)
        trace.append((dt, sid, params, q))
    return scenes, signatures, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm", action="store_true",
                    help="run the LM generation demo (repro_torch.launch."
                         "serve_lm) instead of the neighbor service")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", choices=("short", "full"), default=None,
                    help="canned trace size: 'short' (the CI chaos smoke) "
                         "or 'full' (the default-size trace)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request server-side deadline on the simulated "
                         "arrival clock (0 = none)")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="arm a per-tenant SLO target (e.g. "
                         "'latency_ms:250,objective:0.9'); the gate exits "
                         "nonzero if any tenant's attainment falls below "
                         "its objective (default: the REPRO_SLO knob)")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--signatures", type=int, default=2,
                    help="distinct (radius, K) request signatures in the mix")
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="Poisson arrival rate (requests/s of trace time)")
    ap.add_argument("--qmin", type=int, default=8)
    ap.add_argument("--qmax", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)

    if args.lm:
        from . import serve_lm
        return serve_lm.main(rest + ["--device", args.device]
                             + (["--smoke"] if args.smoke else []))
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.trace == "short":
        args.smoke = True
    if args.smoke:
        args.scenes, args.points = min(args.scenes, 2), 1200
        args.requests, args.qmax = 64, 32

    import torch

    from repro_torch import obs
    from repro_torch.core import SearchOpts
    from repro_torch.core.api import resolve_device
    from repro_torch.obs import flight, slo
    from repro_torch.reliability import faults
    from repro_torch.serve import (CircuitOpen, NeighborService, QueryError,
                                   Rejected, ServeOpts)

    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    sopts = SearchOpts(use_pallas=dev.type == "cuda")

    if args.slo:
        slo.configure(slo.SLOTarget.parse(args.slo))

    opts = ServeOpts(
        max_batch=args.max_batch,
        max_wait_s=(args.max_wait_ms / 1e3
                    if args.max_wait_ms is not None else None),
        deadline_s=args.deadline_ms / 1e3)
    svc = NeighborService(opts, device=dev)
    scenes, signatures, trace = build_trace(args)
    # register + warm every (scene, signature) variant at the common
    # launch bucket, so steady-state latency (not index builds and first
    # launches) is what the trace measures — a real serving process warms
    # at admission too
    t_warm0 = time.perf_counter()
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
        for params in signatures:
            svc.registry.get(sid).variant(params, sopts).warm(args.qmax)
    print(f"serve: warmed {len(scenes)}x{len(signatures)} scene variants "
          f"on {where} in {time.perf_counter() - t_warm0:.1f}s")

    # drive the trace on a simulated arrival clock: submit each request at
    # its arrival time, pumping whenever the bucket deadline has passed;
    # wall-clock (real) time is what QPS/latency are measured in. Every
    # submitted request is accounted to exactly ONE terminal outcome —
    # the reliability taxonomy the chaos gate asserts on.
    outcomes: dict[str, int] = {}

    def account(name):
        outcomes[name] = outcomes.get(name, 0) + 1

    futures, rejected = [], 0
    t_wall0 = time.perf_counter()
    now = 0.0
    for dt, sid, params, q in trace:
        now += dt
        try:
            futures.append((sid, svc.submit(
                sid, q, params, sopts, now=now,
                deadline_s=args.deadline_ms / 1e3 or None)))
        except Rejected:
            rejected += 1
            svc.pump(now=now, force=True)
            try:
                futures.append((sid, svc.submit(
                    sid, q, params, sopts, now=now,
                    deadline_s=args.deadline_ms / 1e3 or None)))
            except (Rejected, CircuitOpen, QueryError) as exc:
                account(type(exc).__name__)
        except (CircuitOpen, QueryError) as exc:
            account(type(exc).__name__)
        svc.pump(now=now)
    reports = svc.drain(now=now)
    wall = time.perf_counter() - t_wall0

    # the zero-hung-futures gate: every admitted future must resolve —
    # a TimeoutError here means a request was stranded, the one failure
    # mode the reliability layer promises cannot happen
    hung = 0
    for _sid, f in futures:
        try:
            f.result(timeout=60.0)
            if f.quality is not None and f.quality.reduced_ladder:
                account("degraded")
            else:
                account("result")
        except TimeoutError:
            hung += 1
            account("HUNG")
        except Exception as exc:
            account(type(exc).__name__)

    st = svc.stats()
    n = len(futures)
    occ = sum(r.nq for r in reports) / max(
        sum(r.pad_n for r in reports), 1)
    snap = svc._metrics.snapshot().get("request_s", {})
    pct = {k: snap.get(k, 0.0) for k in ("p50", "p95", "p99")}
    print(f"serve: {n} requests over {len(scenes)} scenes -> "
          f"{st['batches']} batches ({st['host_syncs']} host syncs), "
          f"{n / wall:.1f} req/s, occupancy {occ:.2f}, "
          f"{rejected} rejected")
    print(f"serve: e2e latency p50={pct['p50'] * 1e3:.2f}ms "
          f"p95={pct['p95'] * 1e3:.2f}ms p99={pct['p99'] * 1e3:.2f}ms")

    plan = faults.active()
    accounted = sum(outcomes.values())
    print("serve: outcomes " + ", ".join(
        f"{k}={v}" for k, v in sorted(outcomes.items())) +
        f" (accounted {accounted}/{len(trace)})")
    if plan is not None:
        inj = {k: v for k, v in plan.stats().items() if v}
        print(f"serve: chaos plan {plan.spec()} injected {inj or 'nothing'}"
              f", breakers {st['breakers'] or '{}'}"
              f", retries={st.get('retries', 0)}"
              f" stragglers={st.get('stragglers', 0)}"
              f" expired={st.get('expired', 0)}")
    # per-tenant outcome breakdown: every terminal outcome the service
    # attributed (ok/degraded/expired/rejected/circuit_open/error),
    # attainment and burn rate per tenant
    print(slo.summary())
    if obs.trace_enabled():
        print(obs.summary())
    if hung:
        # a hung future is THE reliability failure mode — capture the
        # post-mortem before the gate fails (no-op unless REPRO_FLIGHT=1)
        dumped = flight.dump("hung_futures")
        if dumped:
            print(f"serve: flight recorder dumped to {dumped}",
                  file=sys.stderr)
    fail = hung or accounted != len(trace)
    if fail:
        print(f"serve: FAILED — hung futures: {hung}, accounted "
              f"{accounted}/{len(trace)}", file=sys.stderr)
    viol = slo.violations()
    for tenant, (att, obj) in sorted(viol.items()):
        print(f"serve: SLO VIOLATION — tenant {tenant} attainment "
              f"{att:.3f} < objective {obj:.3f}", file=sys.stderr)
    return 1 if (fail or viol) else 0


if __name__ == "__main__":
    sys.exit(main())
