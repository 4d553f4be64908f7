"""Quickstart on the PyTorch port: RTNN-style neighbor search,
functional-first (``examples/quickstart.py`` on the JAX reference).

Every search takes the fused kernel path (``SearchOpts(use_pallas=True)``:
the hand-written ``knn_tile_anchored`` on the card, its plain PyTorch
version on the CPU).

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
      --points 5000 --queries 500
"""
import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.api import SearchParams, SearchResult
from repro_torch.core import NeighborSearch, SearchOpts

OPTS = SearchOpts(use_pallas=True)   # the fused kernel path
RADIUS = 0.05
K = 8


def scenes(n_points: int = 50_000, n_queries: int = 5_000):
    """The reference's point cloud, queries and moved copy, as numpy."""
    rng = np.random.default_rng(0)
    points = rng.random((n_points, 3)).astype(np.float32)  # your point cloud
    queries = rng.random((n_queries, 3)).astype(np.float32)  # where to search
    moved = np.clip(points + rng.normal(0, 1e-3, points.shape),
                    0, 1).astype(np.float32)
    return points, queries, moved


def batched_query(scene_points, queries, spec, device) -> SearchResult:
    """Independent same-spec scenes, one index each, searched in a loop and
    stacked along a leading scene axis (the reference vmaps this)."""
    params = SearchParams(radius=RADIUS, k=K)
    res = [api.query(api.build_index(p, params, OPTS, spec=spec,
                                     device=device), q)
           for p, q in zip(scene_points, queries)]
    return SearchResult(*(torch.stack([getattr(r, f) for r in res])
                          for f in ("indices", "distances2", "counts")))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=5_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    points, queries, moved = scenes(args.points, args.queries)

    # K-nearest-neighbor search, bounded by a radius (the paper's unified
    # (r, K) interface, section 2.1). The index is a plain dataclass of
    # tensors; query is a function of it and the queries.
    index = api.build_index(points, SearchParams(radius=RADIUS, k=K), OPTS,
                            device=dev)
    result = api.query(index, queries)

    print("indices   ", tuple(result.indices.shape), "(-1 padded)")
    print("distances2", tuple(result.distances2.shape), "(inf padded)")
    print("counts    ", result.counts[:10].cpu().numpy())

    # moving points? update_index re-bins into the frozen spec, on device
    index2, stats = api.update_index(index, moved)
    print("update    ", "max_disp2=%.2e" % float(stats.max_disp2),
          "oob=%d" % int(stats.oob))

    # a batch of independent same-spec scenes, one per leading row
    batch = batched_query([points, moved], [queries] * 2, index.spec, dev)
    print("batched   ", tuple(batch.indices.shape), "(2 scenes, stacked)")
    single = [result, api.query(api.build_index(
        moved, SearchParams(radius=RADIUS, k=K), OPTS, spec=index.spec,
        device=dev), queries)]
    for s, want in enumerate(single):
        for f in ("indices", "distances2", "counts"):
            assert torch.equal(getattr(batch, f)[s], getattr(want, f)), (s, f)

    # the eager class surface is a shim over the same core, with the
    # host-planned executor (cost-model bundling) as its optimizing path
    searcher = NeighborSearch(points, SearchParams(radius=RADIUS, k=K), OPTS,
                              device=dev)
    res_eager = searcher.query(queries)
    assert torch.equal(res_eager.counts, result.counts)
    print(f"eager     partitions={searcher.report.num_partitions} "
          f"bundles={len(searcher.report.bundles)} "
          f"t_search={searcher.report.t_search * 1e3:.1f}ms")

    # fixed-radius ("range") search with the same structure: first-K within r
    range_result = NeighborSearch(
        points, SearchParams(radius=RADIUS, k=16, mode="range"),
        SearchOpts(bundle=True, use_pallas=True), device=dev).query(queries)
    print("range counts", range_result.counts[:10].cpu().numpy())
    return dict(result=result, stats=stats, batch=batch, eager=res_eager,
                range=range_result)


if __name__ == "__main__":
    main()
