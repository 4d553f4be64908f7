"""Point-cloud processing pipeline on the PyTorch port: KNN normal
estimation on a KITTI-like LiDAR frame, the perception workload class
(PCL) the paper's KNN serves (``examples/pointcloud_pipeline.py`` on the
JAX reference).

For every point: find K nearest neighbors, fit a local plane (PCA of the
neighborhood covariance), output the normal. Runs the full RTNN pipeline
(schedule + partition + bundle) on the fused kernel path
(``SearchOpts(use_pallas=True)``) and cross-checks a sample against brute
force.

  PYTHONPATH=src python examples/pointcloud_pipeline_torch.py
  PYTHONPATH=src python examples/pointcloud_pipeline_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.core import NeighborSearch, SearchOpts, SearchParams
from repro_torch.data.pointclouds import kitti_like_cloud
from repro_torch.kernels.ref import brute_force_search

K = 16
R = 0.03
OPTS = SearchOpts(use_pallas=True)   # the fused kernel path
N_SAMPLE = 200
EIGH_BATCH = 16384


def covariances(points, nbr_idx):
    """Each point's neighborhood covariance [N, 3, 3] over its valid
    neighbors (``-1`` pads excluded; an empty list counts as one)."""
    valid = (nbr_idx >= 0)[..., None]
    nbrs = points[nbr_idx.clamp_min(0).long()]              # [N, K, 3]
    cnt = torch.clamp(valid.sum(dim=1), min=1)
    mean = torch.sum(torch.where(valid, nbrs, 0.0), dim=1) / cnt
    centered = torch.where(valid, nbrs - mean[:, None], 0.0)
    return torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]


def estimate_normals(points, nbr_idx):
    """normal = eigenvector of the smallest eigenvalue (up to sign). The
    matrices go to ``torch.linalg.eigh`` in batches of ``EIGH_BATCH``:
    cuSOLVER's batched solver (CUDA 12.8) refuses batches of 32,767 and
    more with ``CUSOLVER_STATUS_INVALID_VALUE``."""
    cov = covariances(points, nbr_idx)
    return torch.cat([torch.linalg.eigh(c)[1][..., 0]
                      for c in cov.split(EIGH_BATCH)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=60_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    pts = kitti_like_cloud(args.points, seed=3)
    t0 = time.perf_counter()
    ns = NeighborSearch(pts, SearchParams(radius=R, k=K), OPTS, device=dev)
    res = ns.query(pts)
    t_search = time.perf_counter() - t0
    points = ns.points
    normals = estimate_normals(points, res.indices)
    print(f"searched {len(pts)} points in {t_search:.2f}s "
          f"({t_search / len(pts) * 1e6:.1f} us/query, "
          f"{ns.report.num_partitions} partitions)")

    # verify sample vs brute force
    _oi, od, _oc = brute_force_search(points, points[:N_SAMPLE], R, K)
    got = res.distances2[:N_SAMPLE]
    match = torch.allclose(torch.where(torch.isinf(got), -1.0, got),
                           torch.where(torch.isinf(od), -1.0, od), atol=1e-5)
    print("sample oracle match:", match)
    # normals on a flat slab should be mostly vertical
    vertical = (normals[:, 2].abs() > 0.9).float().mean()
    print(f"vertical normals: {float(vertical) * 100:.0f}% "
          "(KITTI-like ground slab)")
    assert match
    return dict(result=res, normals=normals, t_search=t_search,
                vertical=float(vertical))


if __name__ == "__main__":
    main()
