"""``repro_torch.api.query(index, queries)`` over a scene built once in
set-up: the functional static path (device planning, one fused kernel
launch). Each call waits for its answer before the next starts.

With ``trace`` the benchmark's own spans time ``plan_query`` and
``execute_plan``, the two calls that ``api.query`` makes (host clock; the
plan is issued to the device without a synchronise)."""
from __future__ import annotations

import time

import torch

from portbench.harness import generators
from portbench.harness.cell import Call


class Entry:
    def __init__(self, config: dict, workload: dict, seed: int, device: str,
                 trace: bool):
        from repro_torch import api
        self.api = api
        self.device = torch.device(device)
        pts = generators.SCENES[config["scene"]](config["n_points"], seed)
        params = api.SearchParams(radius=config["radius"], k=config["k"],
                                  mode=config["mode"],
                                  knn_window=config["knn_window"])
        self.index = api.build_index(pts, params,
                                     api.SearchOpts(use_pallas=True),
                                     device=device)
        self.points = self.index.points
        self.queries = generators.Queries(self.points, workload, seed,
                                          config["radius"])
        self.units = self.points.shape[0]
        self.warmup_calls = int(workload["warmup_calls"])
        self._saved = None
        if trace:
            self._span_inner_calls()

    def _span_inner_calls(self) -> None:
        """Time ``plan_query`` and ``execute_plan`` as ``api.query`` calls
        them (its module's globals), restored by ``close``."""
        import importlib

        from torch.profiler import record_function
        mod = importlib.import_module("repro_torch.core.api")
        self._saved = (mod, mod.plan_query, mod.execute_plan)
        self.spans = {"plan_query": 0.0, "execute_plan": 0.0}

        def spanned(name, fn):
            def inner(*args, **kwargs):
                t0 = time.perf_counter()
                with record_function(f"portbench.{name}"):
                    out = fn(*args, **kwargs)
                self.spans[name] += time.perf_counter() - t0
                return out
            return inner

        mod.plan_query = spanned("plan_query", self._saved[1])
        mod.execute_plan = spanned("execute_plan", self._saved[2])

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream().synchronize()

    def warmup(self) -> None:
        for i in range(self.warmup_calls):
            self.api.query(self.index, self.queries.take())
            self._wait()

    def call(self, i: int) -> Call:
        q = self.queries.take()
        if self._saved is not None:
            self.spans = {"plan_query": 0.0, "execute_plan": 0.0}
        res = self.api.query(self.index, q)
        self._wait()
        info = ({f"{k}_s": v for k, v in self.spans.items()}
                if self._saved is not None else {})
        return Call(result=res, points=self.points, queries=q, info=info)

    def close(self) -> None:
        if self._saved is not None:
            mod, plan, execute = self._saved
            mod.plan_query, mod.execute_plan = plan, execute
            self._saved = None
        self.index = None
