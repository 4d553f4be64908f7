"""Distributed neighbor search: the one-shot surface over the sharded-scene
subsystem (``core/shards.py``), as in the reference's
``core/distributed.py``.

The slabs of the mesh share its one device (``launch/mesh.py``); routing,
the halo exchange and the inverse scatter run on that device with no host
synchronisation, and the per-slab search is ``api.query`` over the slab's
``NeighborIndex``.
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
    """One-shot sharded search: plan, route, search, un-route.

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
