"""The fused search kernel's share of its roofline (%): the least time
the card could take for a call's inputs (``harness/work.py``: in-radius
pairs x 10 operations against 67 TFLOP/s, bytes against 3.35 TB/s) over
the device time a call of ``knn_tile_anchored`` in the quiet traced slice."""
from portbench.harness import readers


def read(run):
    return readers.roofline_share(run, "knn_tile_anchored")
