"""``query_rate`` (queries/s): every query answered in the window over the
whole window, which closes in a device synchronise."""


def read(run):
    window = run.t_end - run.t0
    return sum(run.units) / window if window > 0 else None
