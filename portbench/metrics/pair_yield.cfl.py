"""``pair_yield.cfl`` (%): the share of the fused kernel's compared
candidate pairs that the inputs need, in cell ``sph1m-range32-cfl``: the
in-radius pairs a query needs (``harness/work.py``) over the pairs
``knn_tile_anchored`` compared a query row (its walk counter,
``harness/program.py``)."""
from portbench.harness import program


def read(run):
    return program.pair_yield(run)
