"""``plan_ms.cfl`` (ms): ``StepReport.t_plan``, the replan's host time in
``api.plan_query``, mean over the traced run's steps that replanned
outside the profiled slices."""
from portbench.harness import readers


def read(run):
    v = readers.mean_info(run, "t_plan", where="replanned")
    return None if v is None else 1e3 * v
