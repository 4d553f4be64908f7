"""``plan_ms.query`` (ms): host time a call in ``api.plan_query``, the
benchmark's own span around it inside ``api.query`` (the plan is issued
to the device without a synchronise), mean over the traced run's calls
outside the profiled slices."""
from portbench.harness import readers


def read(run):
    v = readers.mean_info(run, "plan_query_s")
    return None if v is None else 1e3 * v
