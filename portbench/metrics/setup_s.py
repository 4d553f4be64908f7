"""``setup_s`` (s): from the process's start to the first timed call:
imports, loading (and, in a checkout's first run, building) the kernels,
the inputs made from the seed, the index or session, and the warm-up of
the cell's own shapes."""


def read(run):
    return run.setup_s
