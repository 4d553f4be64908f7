"""``partition_ms.planned`` (ms): host time a call in the program's own
``query/plan/partition`` span (the megacell partition plan on the host),
mean over the traced run's calls outside the profiled slices
(``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.span_ms(run, "query/plan/partition")
