"""Partition bundling (paper section 5.2 + appendices A-C).

Cost model (first-order, per bundle):
    T = T_build + T_search
    T_build            = k_build * M              (M = structure size; the
                         paper's BVH build, our per-bundle grid re-fit, both
                         empirically linear — Fig. 15 / fig15 benchmark)
    T_search (KNN)     = k_knn   * sum_i N_i * rho_i * S^3     (eq. 4)
    T_search (range)   = k_range * sum_i N_i * K               (appendix A)
where S is the *bundle* window width max_i S_i, N_i/rho_i the member
partitions' query counts and density estimates. ``k_range`` is cheaper when
the sphere test is skippable (paper: 20:1 vs 2:1 against k_build per unit).

Bundling theorem (appendix C): under the empirical inverse correlation
between AABB size and query count, the optimal strategy with M0 bundles
keeps the (M0-1) largest-query-count partitions separate and merges the
rest; M0 is found by a linear scan. Implemented verbatim;
``exhaustive_best`` brute-forces all set-partitions for the property test.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from .partition import Partition


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Relative cost constants. Only ratios matter (paper section 5.2); the
    defaults reproduce the paper's RTX 2080 ratios (k_build:k_knn = 1:15000,
    k_build:k_range = 20:1 skippable / 2:1 tested) rescaled to k_build=1."""

    k_build: float = 1.0
    k_knn: float = 15000.0
    k_range_skip: float = 1.0 / 20.0
    k_range_test: float = 1.0 / 2.0

    def search_cost(self, parts: Sequence[Partition], w_bundle: int,
                    cell_size: float, mode: str, k: int,
                    skip_test: bool) -> float:
        if mode == "knn":
            s3 = ((2 * w_bundle + 1) * cell_size) ** 3
            return self.k_knn * sum(p.count * p.rho for p in parts) * s3
        kq = self.k_range_skip if skip_test else self.k_range_test
        return kq * sum(p.count for p in parts) * k


@dataclasses.dataclass(frozen=True)
class Bundle:
    """A set of partitions searched together with one structure/launch."""

    members: tuple[int, ...]      # indices into the PartitionPlan list
    w_search: int                 # max member window
    skip_test: bool
    count: int

    @property
    def signature(self) -> tuple[int, bool]:
        """Static launch signature ``(w_search, skip_test)`` — the key the
        executor folds same-shaped launches by, and the value domain of the
        functional core's static ladder (``partition.launch_signatures``)."""
        return (int(self.w_search), bool(self.skip_test))


def _mk_bundle(parts: Sequence[Partition], idxs: Sequence[int],
               w_sph: int) -> Bundle:
    ms = [parts[i] for i in idxs]
    w = max(p.w_search for p in ms)
    # a merged bundle may only skip the sphere test if every member could
    # and the merged window is still sphere-inscribed (DESIGN.md section 2)
    skip = all(p.skip_test for p in ms) and w <= w_sph
    return Bundle(members=tuple(idxs), w_search=w, skip_test=skip,
                  count=sum(p.count for p in ms))


def bundle_query_sel(plan, bundle: Bundle) -> np.ndarray:
    """Scheduled-order query positions of a bundle's member partitions,
    concatenated (shared by the executor's launch grouping and the legacy
    host loop so both paths stay bit-identical)."""
    return np.concatenate([
        plan.perm[p.start:p.start + p.count]
        for p in (plan.partitions[i] for i in bundle.members)
    ])


def bundle_cost(bundle: Bundle, parts: Sequence[Partition], model: CostModel,
                *, n_points: int, cell_size: float, mode: str,
                k: int) -> float:
    ms = [parts[i] for i in bundle.members]
    return model.k_build * n_points + model.search_cost(
        ms, bundle.w_search, cell_size, mode, k, bundle.skip_test)


def total_cost(bundles: Sequence[Bundle], parts: Sequence[Partition],
               model: CostModel, **kw) -> float:
    return sum(bundle_cost(b, parts, model, **kw) for b in bundles)


def plan_bundles(
    parts: Sequence[Partition],
    model: CostModel,
    *,
    n_points: int,
    cell_size: float,
    mode: str,
    k: int,
    w_sph: int,
    enable: bool = True,
) -> list[Bundle]:
    """Paper appendix C: sort by query count ascending; for each candidate
    bundle count M0, merge the (M - M0 + 1) smallest-N partitions, keep the
    rest separate; return the argmin-cost strategy. ``enable=False`` is the
    paper's Listing-3 default (one bundle per partition)."""
    m = len(parts)
    if m == 0:
        return []
    # N ascending, by count alone as the reference sorts, so that the
    # bundles match its bundles; with tied counts this scan can miss the
    # exhaustive optimum (ns=[1,1,1,1], ws=[6] costs 680000.0 against
    # 677531.04), a fault of the reference kept on purpose
    order = sorted(range(m), key=lambda i: parts[i].count)
    if not enable or m == 1:
        return [_mk_bundle(parts, (i,), w_sph) for i in range(m)]

    kw = dict(n_points=n_points, cell_size=cell_size, mode=mode, k=k)
    best: list[Bundle] | None = None
    best_cost = np.inf
    for m0 in range(1, m + 1):
        merged = order[: m - m0 + 1]
        separate = order[m - m0 + 1:]
        strat = [_mk_bundle(parts, tuple(sorted(merged)), w_sph)]
        strat += [_mk_bundle(parts, (i,), w_sph) for i in separate]
        c = total_cost(strat, parts, model, **kw)
        if c < best_cost:
            best_cost, best = c, strat
    assert best is not None
    return best


def exhaustive_best(
    parts: Sequence[Partition],
    model: CostModel,
    *,
    n_points: int,
    cell_size: float,
    mode: str,
    k: int,
    w_sph: int,
) -> tuple[list[Bundle], float]:
    """Brute-force optimal bundling over all set partitions (test oracle;
    the paper's "Oracle" variant in Fig. 13). Exponential — small M only."""
    m = len(parts)
    kw = dict(n_points=n_points, cell_size=cell_size, mode=mode, k=k)
    best, best_cost = None, np.inf
    for grouping in _set_partitions(list(range(m))):
        strat = [_mk_bundle(parts, tuple(g), w_sph) for g in grouping]
        c = total_cost(strat, parts, model, **kw)
        if c < best_cost:
            best_cost, best = c, strat
    return best, float(best_cost)


def _set_partitions(items: list[int]):
    if len(items) == 1:
        yield [items]
        return
    first, rest = items[0], items[1:]
    for smaller in _set_partitions(rest):
        for i in range(len(smaller)):
            yield smaller[:i] + [[first] + smaller[i]] + smaller[i + 1:]
        yield [[first]] + smaller


def calibrate(build_fn, n_build_units: int, search_fn, n_search_units: float,
              *, repeats: int = 3) -> CostModel:
    """Offline profiling of the k_build : k_search ratios on this backend
    (paper: "obtained offline through profiling"). ``build_fn()`` builds a
    structure over ``n_build_units`` points; ``search_fn()`` performs
    ``n_search_units`` units of search work (N*rho*S^3 for KNN). Both must
    return only when the device work is done (end in
    ``torch.cuda.synchronize()`` on the card)."""

    def _time(f):
        f()  # warmup/compile
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    k_build = _time(build_fn) / max(n_build_units, 1)
    k_search = _time(search_fn) / max(n_search_units, 1e-9)
    scale = 1.0 / k_build
    return CostModel(k_build=1.0, k_knn=k_search * scale,
                     k_range_skip=k_search * scale / 20.0,
                     k_range_test=k_search * scale / 2.0)
