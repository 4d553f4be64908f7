"""``fetch_ms.planned`` (ms): host time a call in the program's own
``query/plan/fetch`` span (the scheduled queries' megacells and their
one blocking copy to the host), mean over the traced run's calls outside
the profiled slices (``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.span_ms(run, "query/plan/fetch")
