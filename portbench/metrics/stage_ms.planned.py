"""``stage_ms.planned`` (ms): host time a call in the program's own
``query/plan/stage`` span (padding, pinning and uploading each group's
selection), mean over the traced run's calls outside the profiled slices
(``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.span_ms(run, "query/plan/stage")
