"""What the program reports about itself, read after the window: its own
spans (``repro_torch.obs.recent_spans()``, the ring that keeps every span
whatever ``REPRO_TRACE`` says) and its kernels' device counters
(``repro_torch.obs.kernel_counters()``). A program that records neither
gives None, never 0."""
from __future__ import annotations

import bisect
import statistics


def _obs():
    from repro_torch import obs
    return obs


def span_ms(run, path: str):
    """Mean host milliseconds a call spends in the program's span ``path``
    (its records summed per call), over the calls outside the profiled
    slices (no ``host_hooks``) that hold it. A record belongs to call j
    when its start lies in ``[stamps[j], stamps[j + 1])`` (the last call's
    to the window's end), on the ``perf_counter`` clock of both. None
    where no such call holds the span."""
    if not run.stamps:
        return None
    ends = run.stamps[1:] + [run.t_end]
    per_call: dict = {}
    for rec in _obs().recent_spans():
        if rec.get("path") != path:
            continue
        j = bisect.bisect_right(run.stamps, rec["t0_s"]) - 1
        if j < 0 or rec["t0_s"] >= ends[j] or run.infos[j].get("host_hooks"):
            continue
        per_call[j] = per_call.get(j, 0.0) + rec["dur_s"]
    return 1e3 * statistics.fmean(per_call.values()) if per_call else None


def pair_yield(run):
    """100 x the in-radius pairs a query needs (the mean of ``run.work``'s
    ``pairs`` over ``n_points`` queries) over the candidate pairs that
    ``knn_tile_anchored`` compared a query row (its walk counter's
    ``candidate_pairs`` over ``query_rows``). None without the counter or
    where the kernel never ran, such as on the CPU."""
    if not run.work:
        return None
    counters = getattr(_obs(), "kernel_counters", None)
    if counters is None:
        return None
    walk = counters().get("knn_tile_anchored")
    if not walk or not walk["query_rows"] or not walk["candidate_pairs"]:
        return None
    need = (statistics.fmean(w["pairs"] for w in run.work)
            / run.config["n_points"])
    if need <= 0:
        return None
    return 100.0 * need / (walk["candidate_pairs"] / walk["query_rows"])
