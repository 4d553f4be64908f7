"""Distributed neighbor search: the one-shot surface over the sharded-scene
subsystem (``core/shards.py``), as in the reference's
``core/distributed.py``.

The mesh (``launch/mesh.py``) is passed through unchanged: without a rank
layout its slabs share its one device; with one, each rank searches its
block of (slab, query column) cells on its own device, halos go rank to
rank and the results are gathered, so every rank returns the whole
result. Routing, the halo exchange and the inverse scatter run on the
device with no host synchronisation, and the per-slab search is
``api.query`` over the slab's ``NeighborIndex``.
"""
from __future__ import annotations

import dataclasses

from .shards import STATIC_SCENE_OPTS, shard_scene
from .types import SearchOpts, SearchParams, SearchResult


def distributed_neighbor_search(mesh, points, queries,
                                params: SearchParams,
                                slab_axis: str = "data",
                                query_axis: str = "model",
                                cell_size: float | None = None,
                                opts: SearchOpts = SearchOpts()
                                ) -> SearchResult:
    """One-shot sharded search: plan, route, search, gather, un-route.

    Results come back in query order with global point indices. KNN keeps
    this surface's exactness contract: the heuristic window is upgraded to
    the paper's conservative exact window.
    """
    if params.mode == "knn" and params.knn_window != "exact":
        params = dataclasses.replace(params, knn_window="exact")
    index = shard_scene(points, params, mesh=mesh, opts=opts,
                        shopts=STATIC_SCENE_OPTS, queries=queries,
                        cell_size=cell_size, slab_axis=slab_axis,
                        query_axis=query_axis)
    return index.query(queries)


__all__ = ["distributed_neighbor_search"]
