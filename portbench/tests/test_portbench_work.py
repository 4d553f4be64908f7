"""The yardstick's work counts and generators on the CPU: the grid pair
count against brute force, the byte count, and the frozen generators
against the port's and ``chip_smoke.py``'s."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness import generators, reference, work  # noqa: E402

CLOUDS = {
    "kitti": lambda seed: generators.kitti_like_cloud(1500, seed),
    "cube": lambda seed: generators.uniform_cloud(1500, seed),
}


def _brute_counts(points, queries, radius):
    d2 = reference.d2_block(queries, points)
    return (d2 <= reference.radius2(radius)).sum(1)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("mode,k", [("knn", 8), ("range", 32)])
@pytest.mark.parametrize("seed", [0, 3])
def test_pair_counts_equal_brute_force(cloud, mode, k, seed):
    pts = torch.from_numpy(CLOUDS[cloud](seed))
    queries = torch.from_numpy(CLOUDS[cloud](seed + 100))[:700]
    radius = 0.06 if cloud == "kitti" else 0.12
    brute = _brute_counts(pts, queries, radius)
    got = work.in_radius_counts(pts, queries, radius, max_pairs=5000)
    assert torch.equal(got, brute.to(torch.int64))
    w = work.call_work(pts, queries, radius, k, mode)
    want = int(brute.sum() if mode == "knn"
               else torch.clamp_max(brute, k).sum())
    assert w["pairs"] == want
    assert w["ops"] == want * work.OPS_PER_PAIR
    assert w["bytes"] == 1500 * 12 + 700 * 12 + 700 * k * 8 + 700 * 4
    assert w["bound_s"] == max(w["ops"] / work.PEAK_FP32,
                               w["bytes"] / work.PEAK_BYTES)


def test_pair_count_includes_the_radius_boundary():
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.25, 0.0, 0.0]])
    got = work.in_radius_counts(pts, pts[:1], 0.5)
    brute = _brute_counts(pts, pts[:1], 0.5)
    assert int(got[0]) == int(brute[0]) == 3


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_kitti_generator_is_the_ports(seed):
    from repro_torch.data.pointclouds import kitti_like_cloud
    ours = generators.kitti_like_cloud(4000, seed)
    assert np.array_equal(ours, kitti_like_cloud(4000, seed))
    assert not np.array_equal(ours, generators.kitti_like_cloud(4000,
                                                               seed + 1))


@pytest.mark.parametrize("seed", [7, 2**32 + 9])
def test_trajectory_is_chip_smokes(seed):
    import chip_smoke
    frames, vel = generators.trajectory(3000, 4, seed, 1.5e-4)
    want_frames, want_vel = chip_smoke.trajectory(3000, 4, seed, 1.5e-4)
    assert all(np.array_equal(a, b) for a, b in zip(frames, want_frames))
    assert np.array_equal(vel, want_vel)
    other, _ = generators.trajectory(3000, 4, seed + 1, 1.5e-4)
    assert not np.array_equal(frames[0], other[0])


def test_walk_step_follows_the_trajectory_models_velocities():
    pos = torch.full((4, 3), 0.5)
    vel = torch.full((4, 3), 0.01)
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn((4, 3), generator=torch.Generator().manual_seed(3))
    new_pos, new_vel = generators.walk_step(pos, vel, 0.02, gen)
    assert torch.allclose(new_vel, 0.9 * vel + 0.3 * 0.02 * noise)
    assert torch.equal(new_pos, pos + new_vel)


def test_walk_step_clips_at_the_walls():
    pos = torch.tensor([[0.01, 0.5, 0.99]])
    vel = torch.tensor([[-0.03, 0.0, 0.02]])
    gen = torch.Generator().manual_seed(0)
    new_pos, new_vel = generators.walk_step(pos, vel, 0.0, gen, damping=1.0)
    assert torch.equal(new_pos, torch.tensor([[0.0, 0.5, 1.0]]))
    assert torch.equal(new_vel, vel)


def test_jittered_queries_are_seeded_distinct_and_inside_the_scene():
    pts = torch.from_numpy(generators.kitti_like_cloud(2000, 4))
    wl = {"queries": "jitter", "jitter_radii": 0.25}
    a = generators.Queries(pts, wl, 11, 0.02)
    b = generators.Queries(pts, wl, 11, 0.02)
    first = a.take()
    assert torch.equal(first, b.take())
    assert not torch.equal(first, a.take())
    assert not torch.equal(first, generators.Queries(pts, wl, 12,
                                                     0.02).take())
    assert bool((first >= pts.min(0).values).all())
    assert bool((first <= pts.max(0).values).all())
    assert generators.Queries(pts, {"queries": "self"}, 1, 0.02).take() is pts


def test_seed_streams_take_any_whole_number():
    for seed in (0, 1, 2**31 + 1, 2**63 + 7, 2**70):
        assert 0 <= generators.torch_seed(seed, 3) < 2**63
    assert generators.torch_seed(5, 3) != generators.torch_seed(5, 4)
    assert (generators.rng(2**40, 1).integers(0, 2**30)
            == generators.rng(2**40, 1).integers(0, 2**30))
