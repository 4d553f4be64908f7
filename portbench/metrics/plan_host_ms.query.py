"""``plan_host_ms.query`` (ms): host time a call in the program's own
``query/plan`` span (api.plan_query inside api.query, issued to the
device without a synchronise; beside plan_ms.query, the benchmark's own
timing of the same call), mean over the traced run's calls outside the
profiled slices (``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.span_ms(run, "query/plan")
