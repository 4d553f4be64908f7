"""Core library of the PyTorch port: the functional query path, the
host-planned search and the dynamic session.

    build_index, plan_query, execute_plan,   functional core (core/api.py)
    query, query_concat, update_index,
    NeighborIndex, QueryPlan, cached_searcher
    NeighborSearch, neighbor_search          eager host-planned search
    QueryExecutor, PlanHandle, PendingResult (core/search.py, core/executor.py)
    SimulationSession, SessionOpts           dynamic scenes (core/dynamic.py)
    ShardedSession, ShardedIndex,            sharded scenes (core/shards.py)
    shard_scene, plan_layout, SlabLayout,
    ShardOpts
    SearchParams, SearchOpts, SearchResult, GridSpec
    build_cell_grid, choose_grid_spec        acceleration structure
    schedule_queries, schedule_by_level      section 4 query scheduling
    compute_megacells, plan_partitions       section 5.1 partitioning
    plan_bundles, CostModel                  section 5.2 bundling
"""
from .types import (CellGrid, GridSpec, SearchOpts, SearchParams,
                    SearchResult, UpdateStats)
from .grid import (box_count, build_cell_grid, choose_grid_spec,
                   update_cell_grid, update_cell_grid_traced)
from .morton import morton_argsort, morton_decode, morton_encode
from .schedule import (coherence_statistic, schedule_by_level,
                       schedule_cells, schedule_queries)
from .partition import (MegacellStatics, Partition, PartitionPlan,
                        compute_megacells, launch_signatures,
                        megacell_statics, plan_partitions, signature_levels,
                        trivial_plan)
from .bundle import Bundle, CostModel, calibrate, exhaustive_best, plan_bundles
from .search import (NeighborSearch, neighbor_search, window_search,
                     window_tile_search)
from .api import (NeighborIndex, QueryPlan, build_index, cached_searcher,
                  execute_plan, plan_query, query, query_concat,
                  update_index)
from .executor import PendingResult, PlanHandle, QueryExecutor
from .dynamic import (SessionOpts, SimulationSession, StepReport,
                      session_grid_spec)
from .shards import (ShardOpts, ShardedIndex, ShardedSession, SlabLayout,
                     plan_layout, shard_scene)

__all__ = [
    "NeighborIndex", "QueryPlan", "build_index", "cached_searcher",
    "execute_plan", "plan_query", "query", "query_concat", "update_index",
    "PendingResult", "PlanHandle", "QueryExecutor", "SessionOpts",
    "SimulationSession", "StepReport", "UpdateStats", "schedule_cells",
    "session_grid_spec", "update_cell_grid", "update_cell_grid_traced",
    "CellGrid", "GridSpec", "SearchOpts", "SearchParams", "SearchResult",
    "build_cell_grid", "choose_grid_spec", "box_count", "morton_encode",
    "morton_decode", "morton_argsort", "schedule_queries",
    "schedule_by_level", "coherence_statistic", "MegacellStatics",
    "Partition", "PartitionPlan", "compute_megacells", "launch_signatures",
    "megacell_statics", "plan_partitions", "signature_levels",
    "trivial_plan", "Bundle", "CostModel", "calibrate", "exhaustive_best",
    "plan_bundles", "NeighborSearch", "neighbor_search", "window_search",
    "window_tile_search", "ShardOpts", "ShardedIndex", "ShardedSession",
    "SlabLayout", "plan_layout", "shard_scene",
]
