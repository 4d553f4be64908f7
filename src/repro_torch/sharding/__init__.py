"""Sharding rules of the port (``src/repro/sharding/``): partition specs
for parameters, optimizer state, batches, decode caches and activations,
and their DTensor placements."""
from .rules import (P, batch_axes, batch_pspec, cache_pspecs,  # noqa: F401
                    make_shard_fn, mesh_shape, opt_pspecs, param_pspec,
                    param_pspecs, place_parameters, place_tree,
                    placements)
