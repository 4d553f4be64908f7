"""``fingerprint_ms.planned`` (ms): host time a call in the program's own
``query/plan/fingerprint`` span (the sha1 of the plan inputs that keys
the plan cache), mean over the traced run's calls outside the profiled
slices (``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.span_ms(run, "query/plan/fingerprint")
