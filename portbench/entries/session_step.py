"""``repro_torch.core.SimulationSession.step(pos)``: a self-query of
moving particles. Set-up makes the first frame and velocities with the
trajectory model from the seed and builds the session on the frozen grid
that the configuration states; every call moves the particles one step
of that model on the device (noise from a ``torch.Generator`` seeded
from the seed, positions clipped to the unit box), then steps the session
(re-bin, one telemetry fetch, replay or replan or respec, one fused
search launch). ``step`` returns with the search in flight; the next
call's fetch waits for it, and the window's closing synchronise for the
last."""
from __future__ import annotations

import torch

from portbench.harness import generators
from portbench.harness.cell import Call


def frozen_grid(core, config: dict):
    """The session's frozen grid as the configuration states it: the unit
    box padded by ``margin_radii`` radii and one cell a side (the session's
    own padding), cells of ``cell_size``, ``capacity`` slots a cell. Every
    seed gets the same grid, so the seed does not change the work."""
    import math
    g = config["grid"]
    lo = -g["margin_radii"] * config["radius"]
    cell = g["cell_size"]
    dim = math.ceil((1.0 - 2 * lo) / cell) + 3
    return core.GridSpec(origin=(lo - cell,) * 3, cell_size=cell,
                         dims=(dim,) * 3, capacity=g["capacity"])


class Entry:
    def __init__(self, config: dict, workload: dict, seed: int, device: str,
                 trace: bool):
        from repro_torch import core
        self.sigma = float(workload["sigma_radii"]) * config["radius"]
        self.damping = float(config["walk_damping"])
        self.kick = float(config["walk_kick"])
        frames, vel = generators.trajectory(config["n_points"], 1, seed,
                                            self.sigma)
        self.pos = torch.from_numpy(frames[0]).to(device)
        self.vel = torch.from_numpy(vel).to(device)
        self.gen = torch.Generator(device=self.pos.device)
        self.gen.manual_seed(generators.torch_seed(seed, 4))
        params = core.SearchParams(radius=config["radius"], k=config["k"],
                                   mode=config["mode"],
                                   knn_window=config["knn_window"])
        self.sess = core.SimulationSession(
            self.pos, params, core.SearchOpts(use_pallas=True),
            spec=frozen_grid(core, config), device=device)
        self.units = 1
        self.warmup_steps = int(workload["warmup_steps"])

    def _advance(self):
        self.pos, self.vel = generators.walk_step(
            self.pos, self.vel, self.sigma, self.gen, self.damping, self.kick)
        return self.pos

    def warmup(self) -> None:
        for _ in range(self.warmup_steps):
            self.sess.step(self._advance())

    def call(self, i: int) -> Call:
        pos = self._advance()
        res = self.sess.step(pos)
        rep = self.sess.report
        kind = ("respec" if rep.respecced else "replan" if rep.replanned
                else "replay")
        return Call(result=res, points=pos, queries=pos, kind=kind,
                    info={"replanned": rep.replanned, "t_plan": rep.t_plan})

    def close(self) -> None:
        self.sess = None
