"""``step_p95_ms.cfl`` (ms), the cfl cell's: the 95th percentile of the
window's steps, each timed from its call to the next step's call, the
last to the window's closing synchronise (the inclusive method of
``statistics.quantiles``)."""
import statistics


def read(run):
    d = run.durations
    if len(d) < 2:
        return None
    return 1e3 * statistics.quantiles(d, n=20, method="inclusive")[18]
