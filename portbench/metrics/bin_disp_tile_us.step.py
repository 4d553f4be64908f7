"""``bin_disp_tile_us.step`` (us): device time a step of the update kernel
``bin_disp_tile`` in the quiet traced slice (``torch.profiler``, by
kernel name)."""
from portbench.harness import readers


def read(run):
    return readers.kernel_us_per_call(run, "bin_disp_tile")
