"""Arithmetic that several metric readers share. A reader returns None
where its run holds nothing to read; it never returns 0 for a share of a
roofline."""
from __future__ import annotations

import statistics


def mean_info(run, key: str, where: str | None = None):
    """Mean of ``key`` over the calls' reports (those with ``where`` true
    if given), leaving out the calls that ran under the profiler
    (``host_hooks``), whose host times its hooks slow; None if no call
    has it."""
    vals = [info[key] for info in run.infos if key in info
            and not info.get("host_hooks")
            and (where is None or info.get(where))]
    return statistics.fmean(vals) if vals else None


def roofline_share(run, kernel: str):
    """100 x the least time the card could take for a call's inputs (the
    mean over the compared calls, ``work.call_work``) over the device time
    a call of the kernels named ``kernel`` (all of the quiet traced
    slice's launches over its calls)."""
    if not run.profile or not run.work:
        return None
    secs, launches = run.kernel_seconds(kernel)
    calls = run.profile["calls"]
    if not launches or secs <= 0 or not calls:
        return None
    bound = statistics.fmean(w["bound_s"] for w in run.work)
    return 100.0 * bound / (secs / calls)


def idle_share(run):
    """100 x the share of a call's time in which no operation ran on the
    device, at the untraced pace: 1 - the device's busy time a call in
    the quiet traced slice over the mean duration of the traced run's
    untraced calls."""
    p = run.profile
    if not p or not p["calls"] or not p.get("untraced_call_s"):
        return None
    return 100.0 * (1 - p["busy_s"] / p["calls"] / p["untraced_call_s"])


def kernel_us_per_call(run, kernel: str):
    """Device microseconds a call of the kernels named ``kernel``."""
    if not run.profile:
        return None
    secs, launches = run.kernel_seconds(kernel)
    if not launches:
        return None
    return 1e6 * secs / run.profile["calls"]
