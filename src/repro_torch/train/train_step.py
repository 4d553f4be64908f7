"""Training step factory: microbatched gradient accumulation + AdamW (the
port of ``src/repro/train/train_step.py``).

PyTorch runs eagerly, so the steps are plain closures (no jit). A step
takes the model whose parameters require gradients (``init_params(...,
requires_grad=True)``), updates it in place and returns it.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.config import ArchConfig
from ..models.model import LM, NO_SHARD, scanned_params, train_forward
from .optimizer import OptConfig, apply_updates

Tensor = torch.Tensor


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    shard=NO_SHARD, remat: bool = True) -> Callable:
    """Returns ``train_step(params, opt_state, batch)`` -> ``(params,
    opt_state, metrics)``.

    ``batch`` tensors carry a leading microbatch axis: [n_micro, B_micro,
    ...]. Each microbatch's gradients accumulate, in float32, into the
    parameters' ``.grad`` (float32 parameters; others are refused), which
    then hold the mean gradient until the next step clears them. A
    parameter that no microbatch's loss reaches (an MoE's ``router_bias``,
    which shifts only the top-k selection) keeps ``.grad`` None, and the
    optimizer takes it as a zero gradient, as ``jax.grad`` returns zeros
    there. The metrics are device scalars: the mean ``loss``,
    ``grad_norm`` and ``lr``; nothing is fetched to the host.

    Sharded: with the parameters placed as DTensors
    (``sharding.rules.place_parameters``), the batch placed over "data"
    (``place_tree``), the optimizer state from ``init_opt_state`` (placed
    by ``opt_pspecs``) and ``shard=make_shard_fn(mesh)``, the same step
    runs on the mesh, under :func:`replicating`."""

    def train_step(params: LM, opt_state: dict, batch: dict[str, Tensor]):
        named = dict(params.named_parameters())
        with replicating(named.values()):
            return _step(params, named, opt_state, batch)

    def _step(params, named, opt_state, batch):
        for name, p in named.items():
            if not p.requires_grad or p.dtype != torch.float32:
                raise ValueError(
                    f"train_step: parameter {name} is {p.dtype}, requires_"
                    f"grad={p.requires_grad}; training takes float32 "
                    "parameters that require gradients (init_params(..., "
                    "requires_grad=True))")
            p.grad = None
        n_micro = next(iter(batch.values())).shape[0]
        loss = None
        for i in range(n_micro):
            micro = {k: v[i] for k, v in batch.items()}
            li = train_forward(params, micro, cfg, shard=shard, remat=remat)
            li.backward()
            loss = li.detach() if loss is None else loss + li.detach()
        if n_micro > 1:
            loss = loss / n_micro
            for p in named.values():
                if p.grad is not None:
                    p.grad.div_(n_micro)
        grads = {name: p.grad for name, p in named.items()}
        _, opt_state, opt_metrics = apply_updates(
            named, grads, opt_state, opt_cfg, stacked=scanned_params(params))
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def replicating(tensors):
    """``implicit_replication()`` where any of ``tensors`` is a DTensor,
    else nothing: a sharded step meets plain tensors that every rank
    computes alike (masks, rotary tables, positions, the optimizer's step
    and learning rate), which DTensor then takes as replicated."""
    import contextlib

    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in tensors):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_eval_step(cfg: ArchConfig, *, shard=NO_SHARD) -> Callable:
    """Returns ``eval_step(params, batch)``: the first microbatch's loss,
    without autograd (so the recurrence runs ``rwkv_scan``)."""

    @torch.no_grad()
    def eval_step(params: LM, batch: dict[str, Tensor]) -> Tensor:
        micro = {k: v[0] for k, v in batch.items()}
        return train_forward(params, micro, cfg, shard=shard, remat=False)

    return eval_step
