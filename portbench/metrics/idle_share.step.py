"""The device's idle share (%) at the untraced pace: 1 - the device's
busy time a call in the quiet traced slice (``torch.profiler``, the
device's operations alone) over the mean duration of the run's untraced
calls."""
from portbench.harness import readers


def read(run):
    return readers.idle_share(run)
