"""obs_top — a curses-free live view over the telemetry registry (the
reference's ``launch/obs_top.py`` on PyTorch, plus ``--device``).

Renders a periodically-refreshing text dashboard of the serving stack:
process-wide QPS / end-to-end p50/p99 / queue depth / batch occupancy
(from the ``serve`` component of the unified registry) plus the per-tenant
SLO table (requests, outcome mix, attainment, burn rate, latency
percentiles from ``repro_torch.obs.slo``). No curses — each frame is a
plain text block, with an ANSI home+clear prefix when stdout is a TTY and
nothing but a separator otherwise, so it pipes and logs cleanly.

The registry is in-process state, so ``obs_top`` is a *library* view:
call :func:`render` (one frame as a string) or :func:`run` (the refresh
loop) from the process that is serving. The module entrypoint wraps that
in a self-contained demo — ``--demo`` drives a small seeded trace
through a ``NeighborService`` on a background thread while the view
refreshes — which is also the smoke:

  PYTHONPATH=src python -m repro_torch.launch.obs_top --demo --frames 3
  PYTHONPATH=src python -m repro_torch.launch.obs_top --demo --frames 1 \\
      --device cpu

The demo's service runs on ``--device`` (default ``cuda``; without a card
it raises, and the CPU runs only with ``--device cpu``).

``--frames N`` bounds the run (0 = until interrupted); ``--interval``
sets the refresh period; ``--openmetrics`` prints one OpenMetrics scrape
instead of the table (the same numbers, machine-readable).
"""
from __future__ import annotations

import argparse
import sys
import time


def _serve_row(metrics: dict, name: str) -> dict:
    return metrics.get(name, {})


def render(prev: dict | None = None, now: float | None = None) -> tuple:
    """One dashboard frame. Returns ``(text, state)``; pass ``state``
    back as ``prev`` on the next call so rate-style numbers (QPS) are
    per-interval deltas rather than lifetime means."""
    from repro_torch import obs
    from repro_torch.obs import slo

    t = time.monotonic() if now is None else float(now)
    serve = obs.REGISTRY.aggregate().get("serve", {})
    requests = _serve_row(serve, "requests").get("value", 0.0)
    resolved = _serve_row(serve, "resolved").get("value", 0.0)
    state = {"t": t, "requests": requests, "resolved": resolved}

    if prev:
        dt = max(t - prev["t"], 1e-9)
        qps = (requests - prev["requests"]) / dt
        rps = (resolved - prev["resolved"]) / dt
    else:
        qps = rps = 0.0

    lat = _serve_row(serve, "request_s")
    occ = _serve_row(serve, "batch_occupancy")
    lines = [
        "== repro_torch obs_top ==",
        f"serve: {requests:.0f} admitted ({qps:.1f} req/s), "
        f"{resolved:.0f} resolved ({rps:.1f}/s), "
        f"{_serve_row(serve, 'batches').get('value', 0):.0f} batches",
        f"queue: depth={_serve_row(serve, 'queue_depth').get('value', 0):.0f}"
        f" rows={_serve_row(serve, 'queue_queries').get('value', 0):.0f}"
        f"  e2e p50={lat.get('p50', 0.0) * 1e3:.2f}ms"
        f" p99={lat.get('p99', 0.0) * 1e3:.2f}ms"
        f"  occupancy p50={occ.get('p50', 0.0):.2f}",
        slo.summary(),
    ]
    return "\n".join(lines), state


def run(interval_s: float = 1.0, frames: int = 0,
        out=None) -> int:
    """The refresh loop: render every ``interval_s`` until ``frames``
    frames have printed (0 = forever) or KeyboardInterrupt."""
    out = sys.stdout if out is None else out
    clear = "\x1b[2J\x1b[H" if out.isatty() else ""
    prev = None
    n = 0
    try:
        while True:
            frame, prev = render(prev)
            if clear:
                out.write(clear + frame + "\n")
            else:
                out.write(frame + "\n--\n")
            out.flush()
            n += 1
            if frames and n >= frames:
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0


def _demo_load(stop, device):
    """A tiny seeded serving workload (the ``--demo`` traffic source)."""
    import numpy as np

    from repro_torch.core import SearchParams
    from repro_torch.serve import NeighborService, ServeOpts

    rng = np.random.default_rng(0)
    svc = NeighborService(ServeOpts(max_wait_s=1e-3), device=device)
    for i in range(2):
        svc.register_scene(f"scene{i}",
                           rng.random((1200, 3)).astype(np.float32))
    params = SearchParams(radius=0.1, k=8, knn_window="exact")
    svc.start()
    try:
        while not stop.is_set():
            sid = f"scene{int(rng.integers(2))}"
            fut = svc.submit(sid, rng.random((16, 3)).astype(np.float32),
                             params)
            fut.result(timeout=30.0)
    finally:
        svc.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in seconds")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames to print before exiting (0 = forever)")
    ap.add_argument("--demo", action="store_true",
                    help="drive a small seeded serving workload in the "
                         "background so the view has live numbers")
    ap.add_argument("--openmetrics", action="store_true",
                    help="print one OpenMetrics scrape and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.api import resolve_device
    device = resolve_device(args.device)
    stop = t = None
    if args.demo:
        import threading
        stop = threading.Event()
        t = threading.Thread(target=_demo_load, args=(stop, device),
                             name="obs-top-demo", daemon=True)
        t.start()
        time.sleep(min(args.interval, 0.5))   # let the first batches land
    try:
        if args.openmetrics:
            from repro_torch import obs
            sys.stdout.write(obs.export_openmetrics())
            return 0
        return run(args.interval, args.frames)
    finally:
        if stop is not None:
            stop.set()
            # wait out the in-flight request, so the process does not tear
            # down under a launch
            t.join(timeout=60.0)


if __name__ == "__main__":
    sys.exit(main())
