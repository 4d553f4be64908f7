"""``repro_torch.core.NeighborSearch(points, ...).query(queries)``: the
host-planned path (Morton schedule, megacell partition plan fetched to the
host, cost-model bundling, one ``knn_tile_anchored`` launch per launch
group, one blocking wait). The index is built in set-up; every call
brings distinct queries, so the executor's plan cache misses and the plan
is made in every call."""
from __future__ import annotations

from portbench.harness import generators
from portbench.harness.cell import Call


class Entry:
    def __init__(self, config: dict, workload: dict, seed: int, device: str,
                 trace: bool):
        from repro_torch import core
        pts = generators.SCENES[config["scene"]](config["n_points"], seed)
        params = core.SearchParams(radius=config["radius"], k=config["k"],
                                   mode=config["mode"],
                                   knn_window=config["knn_window"])
        self.ns = core.NeighborSearch(pts, params,
                                      core.SearchOpts(use_pallas=True),
                                      device=device)
        self.points = self.ns.points
        self.queries = generators.Queries(self.points, workload, seed,
                                          config["radius"])
        self.units = self.points.shape[0]
        self.warmup_calls = int(workload["warmup_calls"])

    def warmup(self) -> None:
        for _ in range(self.warmup_calls):
            self.ns.query(self.queries.take())

    def call(self, i: int) -> Call:
        q = self.queries.take()
        res = self.ns.query(q)
        return Call(result=res, points=self.points, queries=q,
                    info={"t_opt": self.ns.report.t_opt})

    def close(self) -> None:
        self.ns = None
