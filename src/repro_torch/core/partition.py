"""Query partitioning via megacells (paper section 5.1).

Per query, grow a cube of grid cells ("megacell") around the query's cell
until it holds >= K points or its next growth would cross the r-sphere,
evaluated in O(1) per ring on the grid's summed-area table. The megacell
fixes the query's candidate window radius in cells (``w_search``).

Window sizing:
  range:          w_search = w*           (megacell itself, sphere test
                  skippable because the megacell is inscribed in the r-sphere)
  knn heuristic:  S = 2*(3/(4*pi))^(1/3) * a
  knn exact:      S = sqrt(3) * a
where a = (2*w*+1)*cell is the megacell width; all windows are clamped to
the full-radius window w_full = ceil(r/cell).

The host-planned ``plan_partitions``/``trivial_plan``/``inflate_plan_inputs``
belong to the executor and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from .grid import box_count, clamp_box
from .types import CellGrid, SearchParams, Tensor, device_table

# paper section 5.1: 2 * cbrt(3 / (4 pi))
_HEURISTIC_FACTOR = 2.0 * (3.0 / (4.0 * math.pi)) ** (1.0 / 3.0)
_EXACT_FACTOR = math.sqrt(3.0)


def full_window_radius(cell_size: float, radius: float) -> int:
    """Window radius (cells) that always covers the r-ball of any query."""
    return max(1, int(math.ceil(radius / cell_size - 1e-6)))


def max_inscribed_ring(cell_size: float, radius: float) -> int:
    """Largest ring w such that the megacell [c-w, c+w] is guaranteed inside
    the r-sphere of any query in cell c: sqrt(3)*(w+1)*cell <= r."""
    return int(math.floor(radius / (math.sqrt(3.0) * cell_size) + 1e-6)) - 1


@dataclasses.dataclass(frozen=True)
class MegacellStatics:
    """Host-static derived quantities of a (grid, params) pair."""

    w_full: int
    w_sph: int        # max sphere-inscribed ring (-1: none)
    w_loop: int       # rings actually examined (min(w_sph, opts.w_max))

    @property
    def has_megacells(self) -> bool:
        return self.w_loop >= 0


def megacell_statics(cell_size: float, params: SearchParams,
                     w_max: int) -> MegacellStatics:
    w_sph = max_inscribed_ring(cell_size, params.radius)
    return MegacellStatics(
        w_full=full_window_radius(cell_size, params.radius),
        w_sph=w_sph,
        w_loop=min(w_max, w_sph),
    )


def _window_from_ring(w_star: Tensor, found: Tensor, st: MegacellStatics,
                      params: SearchParams) -> tuple[Tensor, Tensor]:
    """Map megacell ring -> (w_search int32, skip_test bool) per query.

    The knn window is ``ceil(0.5*factor*a - 1e-6)`` in float32, with both
    constants rounded to float32 first, as the reference evaluates it.
    """
    a_cells = 2 * w_star + 1                     # megacell width in cells
    if params.mode == "range":
        w_search = torch.where(found, w_star, st.w_full)
        skip = found
    else:
        factor = (_EXACT_FACTOR if params.knn_window == "exact"
                  else _HEURISTIC_FACTOR)
        dev = w_star.device
        half_factor = device_table(np.float32(0.5 * factor), torch.float32,
                                   dev)
        eps = device_table(np.float32(1e-6), torch.float32, dev)
        w_knn = torch.ceil(a_cells.to(torch.float32) * half_factor
                           - eps).to(torch.int32)
        w_search = torch.where(found, torch.clamp_max(w_knn, st.w_full),
                               st.w_full)
        skip = torch.zeros_like(found)           # knn always distance-filters
    return w_search.to(torch.int32), skip


def compute_megacells(
    grid: CellGrid,
    queries: Tensor,
    statics: MegacellStatics,
    params: SearchParams,
    origin: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Vectorized megacell growth.

    Returns per-query ``(w_search, skip_test, rho)`` where ``rho`` is the
    paper's density estimate K/C^3 (section 5.2), C the megacell width.
    """
    nq = queries.shape[0]
    dev = queries.device
    spec = grid.spec
    ccoord = spec.cell_of(queries, origin)

    if not statics.has_megacells:
        w_search = torch.full((nq,), statics.w_full, dtype=torch.int32,
                              device=dev)
        skip = torch.zeros((nq,), dtype=torch.bool, device=dev)
        vol = (2.0 * params.radius) ** 3
        rho = torch.full((nq,), params.k / vol, dtype=torch.float32,
                         device=dev)
        return w_search, skip, rho

    # counts for every ring 0..w_loop, O(1) each via the SAT
    ring_counts = []
    for w in range(statics.w_loop + 1):
        lo, hi = clamp_box(spec, ccoord, w)
        ring_counts.append(box_count(grid.sat, lo, hi))
    counts = torch.stack(ring_counts, dim=-1)           # [Nq, w_loop+1]

    satisfied = counts >= params.k                       # monotone in w
    found = torch.any(satisfied, dim=-1)
    # argmax returns the first maximum, as jnp.argmax does
    w_star = torch.argmax(satisfied.to(torch.int32), dim=-1).to(torch.int32)

    w_search, skip = _window_from_ring(w_star, found, statics, params)

    a = (2.0 * w_star.to(torch.float32) + 1.0) * spec.cell_size
    rho_found = params.k / torch.clamp_min(a ** 3, 1e-30)
    # unfound queries search the full r-window; estimate density from the
    # largest examined ring
    a_last = (2.0 * statics.w_loop + 1.0) * spec.cell_size
    rho_fallback = counts[..., -1].to(torch.float32) / (a_last ** 3)
    rho = torch.where(found, rho_found, torch.clamp_min(rho_fallback, 1e-12))
    return w_search, skip, rho.to(torch.float32)


def launch_signatures(
    statics: MegacellStatics,
    params: SearchParams,
    *,
    margin: int = 0,
    enabled: bool = True,
    w_ladder: tuple[int, ...] | None = None,
) -> tuple[tuple[int, bool], ...]:
    """Host-static ladder of every ``(w_search, skip)`` signature a query
    can be assigned: the megacell rings ``0..w_loop`` mapped through the
    window sizing, plus the full-radius fallback. ``margin`` bakes in the
    staleness inflation; ``w_ladder`` replaces the derived windows with an
    explicit set (queries round up, sphere-test skip disabled).
    """
    return _launch_signatures_cached(statics, params, margin, enabled,
                                     w_ladder)


@lru_cache(maxsize=256)
def _launch_signatures_cached(statics, params, margin, enabled, w_ladder):
    if not enabled or not statics.has_megacells:
        return ((statics.w_full, False),)
    if w_ladder is not None:
        ws = sorted({int(w) for w in w_ladder if 0 <= int(w)}
                    | {statics.w_full})
        return tuple((w, False) for w in ws if w <= statics.w_full)
    pairs = {(statics.w_full, False)}        # not-found / fallback signature
    # evaluate the ring->window map with the same float32 tensor ops that
    # compute_megacells runs, so the ladder windows are bit-identical to
    # the per-query ones (a float64 evaluation could miss a query's window)
    rings = torch.arange(statics.w_loop + 1, dtype=torch.int32)
    w_r, s_r = _window_from_ring(rings, torch.ones_like(rings,
                                                        dtype=torch.bool),
                                 statics, params)
    for w, s in zip(w_r.tolist(), s_r.tolist()):
        w2 = min(int(w) + margin, statics.w_full)
        pairs.add((w2, bool(s) and w2 <= statics.w_sph))
    return tuple(sorted(pairs))


def signature_levels(
    w_search: Tensor,
    skip: Tensor,
    ladder: tuple[tuple[int, bool], ...],
) -> Tensor:
    """Per-query index (int32) into ``ladder``.

    With a derived ladder every ``(w_search, skip)`` pair matches one entry
    exactly; with an explicit ``SearchOpts.w_ladder`` the query rounds up to
    the smallest ladder window >= ``w_search``.
    """
    dev = w_search.device
    exact = torch.zeros(w_search.shape, dtype=torch.int32, device=dev)
    matched = torch.zeros(w_search.shape, dtype=torch.bool, device=dev)
    for i, (wl, sl) in enumerate(ladder):
        hit = (w_search == wl) & (skip == sl)
        exact = torch.where(hit, i, exact)
        matched = matched | hit
    if any(s for _, s in ladder):
        # the defensive fallback must never land on a skip entry
        fb = max(i for i, (_, s) in enumerate(ladder) if not s)
        fallback = torch.full(w_search.shape, fb, dtype=torch.int32,
                              device=dev)
    else:
        ws = device_table([w for w, _ in ladder], torch.int32, dev)
        fallback = torch.clamp(
            torch.searchsorted(ws, w_search.to(torch.int32).contiguous(),
                               side="left"),
            0, len(ladder) - 1).to(torch.int32)
    return torch.where(matched, exact, fallback)
