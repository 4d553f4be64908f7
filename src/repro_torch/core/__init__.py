"""Core library of the PyTorch port: the functional query path and the
dynamic session.

    build_index, plan_query, execute_plan,   functional core (core/api.py)
    query, query_concat, update_index,
    NeighborIndex, QueryPlan
    SimulationSession, SessionOpts           dynamic scenes (core/dynamic.py)
    SearchParams, SearchOpts, SearchResult, GridSpec
    build_cell_grid, choose_grid_spec        acceleration structure
    schedule_queries, schedule_by_level      section 4 query scheduling
    compute_megacells, launch_signatures     section 5.1 partitioning
"""
from .types import (CellGrid, GridSpec, SearchOpts, SearchParams,
                    SearchResult, UpdateStats)
from .grid import (box_count, build_cell_grid, choose_grid_spec,
                   update_cell_grid, update_cell_grid_traced)
from .morton import morton_argsort, morton_decode, morton_encode
from .schedule import (coherence_statistic, schedule_by_level,
                       schedule_cells, schedule_queries)
from .partition import (MegacellStatics, compute_megacells,
                        launch_signatures, megacell_statics,
                        signature_levels)
from .search import window_search, window_tile_search
from .api import (NeighborIndex, QueryPlan, build_index, execute_plan,
                  plan_query, query, query_concat, update_index)
from .dynamic import (SessionOpts, SimulationSession, StepReport,
                      session_grid_spec)

__all__ = [
    "NeighborIndex", "QueryPlan", "build_index", "execute_plan",
    "plan_query", "query", "query_concat", "update_index", "SessionOpts",
    "SimulationSession", "StepReport", "UpdateStats", "schedule_cells",
    "session_grid_spec", "update_cell_grid", "update_cell_grid_traced",
    "CellGrid", "GridSpec", "SearchOpts", "SearchParams", "SearchResult",
    "build_cell_grid", "choose_grid_spec", "box_count", "morton_encode",
    "morton_decode", "morton_argsort", "schedule_queries",
    "schedule_by_level", "coherence_statistic", "MegacellStatics",
    "compute_megacells", "launch_signatures", "megacell_statics",
    "signature_levels", "window_search", "window_tile_search",
]
