"""``step_ms`` (ms): the whole window over the steps completed in it; the
window closes in a device synchronise."""


def read(run):
    n = sum(run.units)
    return 1e3 * (run.t_end - run.t0) / n if n else None
