"""Input generators, frozen copies so that a change to the port or to its
examples cannot move the yardstick.

``kitti_like_cloud`` and ``uniform_cloud`` are copies of
``repro_torch.data.pointclouds``; ``trajectory`` is a copy of the numpy
form of ``benchmarks/fig_dynamic.py``'s trajectory model (a per-point
velocity random walk, clipped to the unit box). ``walk_step`` is that
model's step on tensors, so a session cell moves its particles on the
device. numpy only besides ``walk_step``; nothing of the port.
"""
from __future__ import annotations

import numpy as np


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


def uniform_cloud(n: int, seed: int = 0) -> np.ndarray:
    """Stanford-scan proxy: near-uniform points in the unit cube."""
    rng = np.random.default_rng(seed)
    return rng.random((n, 3), dtype=np.float32)


SCENES = {"kitti_like": kitti_like_cloud, "uniform": uniform_cloud}


def trajectory(n: int, steps: int, seed: int, sigma: float):
    """A per-point velocity random walk, clipped to the unit box. Returns
    the frames and the last velocities."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    vel = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    frames = [pos]
    for _ in range(steps - 1):
        vel = 0.9 * vel + rng.normal(0, 0.3 * sigma,
                                     (n, 3)).astype(np.float32)
        pos = np.clip(pos + vel, 0.0, 1.0).astype(np.float32)
        frames.append(pos)
    return frames, vel


def walk_step(pos, vel, sigma: float, generator, damping: float = 0.9,
              kick: float = 0.3):
    """One step of ``trajectory``'s model on tensors: the velocity damped
    and kicked by noise drawn from ``generator`` on the tensors' device,
    the positions moved by it and clipped to the unit box, the velocity
    kept as it is. Returns new (pos, vel); the caller's tensors are not
    written."""
    import torch
    noise = torch.randn(vel.shape, generator=generator, device=vel.device,
                        dtype=vel.dtype)
    vel = damping * vel + (kick * sigma) * noise
    return torch.clamp(pos + vel, 0.0, 1.0), vel


def seed_words(seed: int, stream: int) -> list[int]:
    """A numpy seed sequence entropy for one stream of a run's seed: any
    whole number, negative and beyond 64 bits included."""
    return [stream, seed & ((1 << 64) - 1), (seed >> 64) & ((1 << 64) - 1),
            int(seed < 0)]


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit ``torch.Generator`` seed for one stream of a run's seed."""
    state = np.random.SeedSequence(seed_words(seed, stream)).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of one stream of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, stream)))


class Queries:
    """The queries of each call of a static cell, as its workload file
    says: ``"queries": "self"`` gives the scene's own points every call;
    ``"jitter"`` gives them moved by a Gaussian of ``jitter_radii`` radii
    a coordinate, drawn on the device afresh for every call from the
    seed and clipped to the scene's bounding box, so every call brings
    distinct queries of the same number and density."""

    def __init__(self, points, workload: dict, seed: int, radius: float):
        import torch
        self.points = points
        self.kind = workload["queries"]
        if self.kind not in ("self", "jitter"):
            raise ValueError(f"unknown queries {self.kind!r}")
        if self.kind == "jitter":
            self.sigma = float(workload["jitter_radii"]) * radius
            self.lo = points.min(0).values
            self.hi = points.max(0).values
            self.gen = torch.Generator(device=points.device)
            self.gen.manual_seed(torch_seed(seed, 3))

    def take(self):
        import torch
        if self.kind == "self":
            return self.points
        noise = torch.randn(self.points.shape, generator=self.gen,
                            device=self.points.device)
        q = self.points + self.sigma * noise
        return torch.minimum(torch.maximum(q, self.lo), self.hi)
