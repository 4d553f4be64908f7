"""Synthetic point-cloud generators mirroring the paper's three datasets.

The paper evaluates on KITTI LiDAR (points confined to a thin z-slab),
Stanford 3-D scans (uniform-ish surface samples), and Millennium N-body
(strongly clustered, fractal). We generate distribution-matched synthetic
clouds so every benchmark exercises the same regimes (this container has no
dataset downloads).
"""
from __future__ import annotations

import numpy as np


def uniform_cloud(n: int, seed: int = 0) -> np.ndarray:
    """Stanford-scan proxy: near-uniform points in the unit cube."""
    rng = np.random.default_rng(seed)
    return rng.random((n, 3), dtype=np.float32)


def kitti_like_cloud(n: int, seed: int = 0, z_range: float = 0.04
                     ) -> np.ndarray:
    """KITTI proxy: xy-plane spread with a narrow z slab (the paper notes
    the LiDAR points are 'confined in a very narrow z-range')."""
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2), dtype=np.float32)
    z = rng.random((n, 1), dtype=np.float32) * z_range
    # ring-like radial density falloff from the sensor, LiDAR-ish
    r = np.sqrt(rng.random((n, 1), dtype=np.float32))
    xy = 0.5 + (xy - 0.5) * r
    return np.concatenate([xy, z], axis=1).astype(np.float32)


def clustered_cloud(n: int, seed: int = 0, n_clusters: int = 64,
                    frac_background: float = 0.1) -> np.ndarray:
    """N-body proxy: hierarchically clustered (galaxy-like) distribution —
    the regime where the paper's partitioning over-fragments (Fig. 12/13
    NBody discussion)."""
    rng = np.random.default_rng(seed)
    n_bg = int(n * frac_background)
    n_cl = n - n_bg
    centers = rng.random((n_clusters, 3), dtype=np.float32)
    sizes = rng.pareto(2.0, n_clusters) + 0.2
    sizes = sizes / sizes.sum()
    counts = rng.multinomial(n_cl, sizes)
    chunks = [rng.normal(centers[i], 0.015 * (1 + sizes[i] * n_clusters / 4),
                         (c, 3)).astype(np.float32)
              for i, c in enumerate(counts) if c > 0]
    pts = np.concatenate(chunks + [rng.random((n_bg, 3), dtype=np.float32)])
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


def dataset_by_name(name: str, n: int, seed: int = 0) -> np.ndarray:
    return {"kitti": kitti_like_cloud, "scan": uniform_cloud,
            "nbody": clustered_cloud}[name](n, seed)
