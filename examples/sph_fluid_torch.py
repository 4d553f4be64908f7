"""End-to-end example on the PyTorch port: a minimal SPH-style fluid step
loop built on the neighbor-search core (``examples/sph_fluid.py`` drives
the JAX reference the same way).

Default path is the dynamic-scene subsystem: ONE persistent
``SimulationSession`` owns a frozen grid across the whole run, each step
re-bins the moved particles on the device (the hand-written kernel
``bin_disp_tile``) and replays the cached plan while displacements stay
small; the search is the fused kernel ``knn_tile_anchored``
(``SearchOpts(use_pallas=True)``; its plain PyTorch version on the CPU).
Positions never leave the device. ``--rebuild`` keeps the legacy path for
A/B: a fresh ``NeighborSearch`` per frame (host spec planning, full
rebuild, cold plan caches: what the session amortizes away).

Each step: (1) update structure over moved particles, (2) range search
around every particle (self-query), (3) density + pressure-force kernel
sums over the returned neighbor lists, (4) symplectic Euler integration.

  PYTHONPATH=src python examples/sph_fluid_torch.py --particles 8000 --steps 5
  PYTHONPATH=src python examples/sph_fluid_torch.py --rebuild   # legacy A/B
  PYTHONPATH=src python examples/sph_fluid_torch.py --device cpu --particles 500
"""
import argparse
import math
import time

import numpy as np
import torch

from repro_torch.core import (NeighborSearch, SearchOpts, SearchParams,
                              SimulationSession)

H = 0.06            # smoothing radius
K_MAX = 32          # bounded neighbor count (the paper's K)
REST_DENSITY = 600.0
STIFFNESS = 200.0
DT = 4e-4
GRAVITY = (0.0, 0.0, -9.8)
OPTS = SearchOpts(use_pallas=True)   # the fused kernel path


def params() -> SearchParams:
    return SearchParams(radius=H, k=K_MAX, mode="range")


def sph_forces(pos, vel, nbr_idx, nbr_d2):
    """Poly6 density + spiky pressure-gradient forces over the fixed-K
    neighbor lists returned by the search, on the device of ``pos``."""
    del vel
    valid = nbr_idx >= 0
    safe = nbr_idx.clamp_min(0).long()
    d2 = torch.where(valid, nbr_d2, H * H)
    c = torch.clamp(H * H - d2, min=0.0)
    w = c * c * c                                            # poly6 core
    density = torch.sum(torch.where(valid, w, 0.0), dim=1) * 315.0 / (
        64.0 * math.pi * H**9) + 1e-6
    pressure = STIFFNESS * torch.clamp(density - REST_DENSITY, min=0.0)

    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    dirs = (pos[:, None, :] - pos[safe]) / d[..., None]
    hd = H - d
    spiky = hd * hd * 45.0 / (math.pi * H**6)
    p_i = pressure[:, None]
    p_j = pressure[safe]
    rho_j = density[safe]
    f = dirs * (spiky * (p_i + p_j) / (2.0 * rho_j))[..., None]
    f = torch.sum(torch.where(valid[..., None], f, 0.0), dim=1)
    gravity = torch.tensor(GRAVITY, dtype=pos.dtype).to(pos.device,
                                                        non_blocking=True)
    return f / density[:, None] + gravity, density


def integrate(pos, vel, acc):
    """Symplectic Euler + reflective box walls, all on the device."""
    vel = vel + DT * acc
    pos = pos + DT * vel
    pos = torch.clamp(pos, 0.0, 1.0)
    vel = torch.where((pos <= 0.0) | (pos >= 1.0), -0.5 * vel, vel)
    return pos, vel


def advance(pos, vel, res):
    """Forces over the search's lists, then integration; no host sync.
    Returns (pos, vel, density)."""
    acc, density = sph_forces(pos, vel, res.indices, res.distances2)
    pos, vel = integrate(pos, vel, acc)
    return pos, vel, density


def _wait(t) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def step_rebuild(pos, vel):
    """Legacy per-frame teardown/rebuild (pre-session behavior)."""
    ns = NeighborSearch(pos, params(), OPTS, device=pos.device)
    t0 = time.perf_counter()
    res = ns.query(pos)
    t_search = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos, vel, density = advance(pos, vel, res)
    _wait(pos)
    t_phys = time.perf_counter() - t0
    split = dict(update=0.0, plan=ns.report.t_opt, search=t_search,
                 physics=t_phys)
    info = (f"partitions={ns.report.num_partitions} "
            f"launches={ns.report.launches} syncs={ns.report.host_syncs}")
    return pos, vel, float(density.mean()), split, info


def step_session(sess, pos, vel):
    """Session path: incremental update + cached-plan replay, self-query."""
    res = sess.step(pos)
    r = sess.report
    t0 = time.perf_counter()
    pos, vel, density = advance(pos, vel, res)
    _wait(pos)
    t_phys = time.perf_counter() - t0
    split = dict(update=r.t_update, plan=r.t_plan, search=r.t_search,
                 physics=t_phys)
    info = (f"fast={int(r.fast)} replan={int(r.replanned)} "
            f"respec={int(r.respecced)} disp={r.max_disp:.4f}")
    return pos, vel, float(density.mean()), split, info


def initial_state(n: int, device):
    """The dam-break column of ``examples/sph_fluid.py``: positions from
    ``np.random.default_rng(0)``, zero velocities."""
    rng = np.random.default_rng(0)
    pos = (rng.random((n, 3), np.float32) * [0.4, 0.4, 0.8]).astype(
        np.float32)
    pos = torch.from_numpy(pos).to(device)
    return pos, torch.zeros_like(pos)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=8000)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rebuild", action="store_true",
                    help="legacy rebuild-per-frame path (A/B baseline)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pos, vel = initial_state(args.particles, torch.device(args.device))
    sess = None
    if not args.rebuild:
        sess = SimulationSession(pos, params(), OPTS, device=pos.device)
    for s in range(args.steps):
        t0 = time.perf_counter()
        if args.rebuild:
            pos, vel, rho, split, info = step_rebuild(pos, vel)
        else:
            pos, vel, rho, split, info = step_session(sess, pos, vel)
        dt = time.perf_counter() - t0
        print(f"step {s}: mean_density={rho:9.1f} wall={dt:.2f}s "
              f"(update={split['update']:.3f} plan={split['plan']:.3f} "
              f"search={split['search']:.3f} "
              f"physics={split['physics']:.3f}) {info}")
    if sess is not None:
        st = sess.stats()
        print(f"session: {st['steps']} steps, {st.get('fast_steps', 0)} "
              f"fast, {st.get('replans', 0)} replans, "
              f"{st.get('respecs', 0)} respecs")
    assert bool(torch.isfinite(pos).all())
    print("ok")


if __name__ == "__main__":
    main()
