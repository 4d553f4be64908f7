"""Fault tolerance of the port (``src/repro/train/fault_tolerance.py``):

  * ``ResilientLoop``: the checkpoint/restart loop. On a step exception
    it restores the latest checkpoint and replays the data stream from the
    saved cursor (a deterministic stream gives exactly-once semantics).
  * ``StragglerMonitor``: an EMA of step durations that flags a step far
    past it (pure Python); the serve pump also uses it to flag drains.
  * ``remesh``: elastic re-sharding of a tree of tensors onto a new
    ``DeviceMesh`` (DTensors placed by ``sharding.rules`` specs).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from .checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerMonitor:
    """EMA of step (or drain) durations; flags a duration above
    ``factor`` x EMA as a straggler, which then does not move the EMA."""

    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.1
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        """Record one step duration; returns True if it is a straggler."""
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.factor * self.ema
        if is_straggler:
            self.flagged += 1
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


def fetch_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """A step's device scalars as Python floats, in one transfer."""
    names = list(metrics)
    vals = torch.stack([metrics[n].detach().to(torch.float32).reshape(())
                        for n in names]).cpu().tolist()
    return dict(zip(names, vals))


class ResilientLoop:
    """Run train steps with checkpoint/restart on failure."""

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 10,
                 max_restarts: int = 3):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.monitor = StragglerMonitor()
        self.restarts = 0

    def run(self, step_fn: Callable, params: Any, opt_state: dict,
            stream_fn: Callable[[int], Iterator], n_steps: int,
            start_step: int = 0):
        """``stream_fn(step)`` must return an iterator positioned at
        ``step`` (``synthetic_stream(start_step=...)``); ``step_fn`` raises
        on a simulated node failure. A failed step restores the latest
        checkpoint in place (with none yet, the stream restarts from
        ``start_step`` on the current state, as in the reference). Each
        completed step fetches its metrics once (one transfer); a save
        fetches the state. Returns (params, opt_state, the metrics of
        every completed step, replays included)."""
        step = start_step
        stream = stream_fn(step)
        metrics_log = []
        while step < n_steps:
            batch = next(stream)
            t0 = time.perf_counter()
            try:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    # no checkpoint yet: restart from the initial state
                    step = start_step
                    stream = stream_fn(step)
                    continue
                params, opt_state, manifest = self.ckpt.restore(
                    params, opt_state)
                step = manifest["step"]
                stream = stream_fn(step)
                continue
            self.monitor.observe(time.perf_counter() - t0)
            metrics_log.append(fetch_metrics(metrics))
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, params, opt_state,
                               extra={"cursor": step})
        return params, opt_state, metrics_log


def remesh(tree: Any, mesh, specs: Any) -> Any:
    """Elastic re-shard: place a tree (dicts and lists) of tensors, plain
    or DTensors on any mesh, onto the ``DeviceMesh`` ``mesh`` with
    ``specs`` (the same tree of ``sharding.rules.P``). Each tensor is
    fetched whole to the host first (a DTensor's ``full_tensor()``, a
    collective on its own mesh), then ``distribute_tensor``-ed, so the
    mesh shape may change. Every rank calls it alike, as in any SPMD
    program; a rank outside ``mesh`` gets an empty local shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ..sharding.rules import placements

    def place(x, spec):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        host = full.detach().cpu()
        return distribute_tensor(host.to(mesh.device_type), mesh,
                                 placements(spec, mesh))

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        return place(node, spec)

    return walk(tree, specs)
