"""``opt_ms.query`` (ms): ``NeighborSearch.report.t_opt`` (schedule,
megacell partition plan and its fetch, bundling, launch preparation),
mean over the traced run's calls outside the profiled slices."""
from portbench.harness import readers


def read(run):
    v = readers.mean_info(run, "t_opt")
    return None if v is None else 1e3 * v
