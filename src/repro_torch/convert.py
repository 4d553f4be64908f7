"""Carry a built index, a captured plan, a host partition plan, a dynamic
session or a language model's parameters and decode cache into the port.

The state of this system is its built grid, its captured query plan and,
for a dynamic session, the positions that plan was captured at. These
functions take that state as numpy arrays and plain values (the static
spec, params and options as dataclasses or as the ``dict`` that
``dataclasses.asdict`` makes of the reference's ones), so that
``execute_plan`` or ``SimulationSession.step`` can run under exactly the
state that another implementation built. A language model's parameters,
gradients, optimizer state and decode cache come as the reference's
nested trees of numpy arrays, with each period's layers stacked on a
leading axis.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.api import NeighborIndex, QueryPlan, resolve_device
from .core.dynamic import SessionOpts, SimulationSession
from .core.partition import Partition, PartitionPlan, megacell_statics
from .core.types import CellGrid, GridSpec, SearchOpts, SearchParams
from .models.model import LM, Cache, init_params, layer_groups


def _spec(spec) -> GridSpec:
    if isinstance(spec, GridSpec):
        return spec
    return GridSpec(origin=tuple(float(o) for o in spec["origin"]),
                    cell_size=float(spec["cell_size"]),
                    dims=tuple(int(d) for d in spec["dims"]),
                    capacity=int(spec["capacity"]))


def _params(params) -> SearchParams:
    return params if isinstance(params, SearchParams) else SearchParams(
        **params)


def _opts(opts) -> SearchOpts:
    if isinstance(opts, SearchOpts):
        return opts
    opts = dict(opts)
    if opts.get("w_ladder") is not None:
        opts["w_ladder"] = tuple(int(w) for w in opts["w_ladder"])
    return SearchOpts(**opts)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype).to(device)


def index_from_arrays(points, dense, counts, sat, overflow, anchor_points,
                      origin, *, spec, params, opts,
                      device="cuda") -> NeighborIndex:
    """A :class:`NeighborIndex` from the arrays of a built index."""
    dev = resolve_device(device)
    spec, params, opts = _spec(spec), _params(params), _opts(opts)
    dx, dy, dz = spec.dims
    grid = CellGrid(
        spec=spec,
        dense=_tensor(dense, torch.int32, dev).reshape(dx, dy, dz,
                                                       spec.capacity),
        counts=_tensor(counts, torch.int32, dev).reshape(dx, dy, dz),
        sat=_tensor(sat, torch.int32, dev).reshape(dx + 1, dy + 1, dz + 1),
        overflow=_tensor(overflow, torch.int32, dev).reshape(()))
    return NeighborIndex(
        params=params, opts=opts,
        statics=megacell_statics(spec.cell_size, params, opts.w_max),
        points=_tensor(points, torch.float32, dev), grid=grid,
        anchor_points=_tensor(anchor_points, torch.float32, dev),
        origin=None if origin is None else _tensor(origin, torch.float32,
                                                   dev))


def plan_from_arrays(perm, tile_levels, *, nq: int, tile: int, ladder,
                     device="cuda") -> QueryPlan:
    """A :class:`QueryPlan` from a captured permutation and tile levels."""
    dev = resolve_device(device)
    return QueryPlan(
        nq=int(nq), tile=int(tile),
        ladder=tuple((int(w), bool(s)) for w, s in ladder),
        perm=_tensor(perm, torch.int32, dev),
        tile_levels=_tensor(tile_levels, torch.int32, dev))


def partition_plan_from_arrays(perm, partitions, *,
                               w_full: int) -> PartitionPlan:
    """A host :class:`PartitionPlan` from another implementation's: its
    partition-sorted permutation and its partitions (objects with the
    fields of :class:`Partition`, or their ``dict``s), so the executor's
    bundles, groups and selections can be compared under the same plan."""
    parts = []
    for p in partitions:
        d = p if isinstance(p, dict) else {
            f: getattr(p, f) for f in Partition.__dataclass_fields__}
        parts.append(Partition(w_search=int(d["w_search"]),
                               skip_test=bool(d["skip_test"]),
                               count=int(d["count"]), rho=float(d["rho"]),
                               start=int(d["start"])))
    return PartitionPlan(perm=np.array(perm, dtype=np.int64, copy=True),
                         partitions=parts, w_full=int(w_full))


def session_from_arrays(points, dense, counts, sat, overflow, anchor_points,
                        origin, *, spec, params, opts, plan=None,
                        anchor_queries=None, sopts=None,
                        device="cuda") -> SimulationSession:
    """A :class:`SimulationSession` resumed at another implementation's
    state: its index as :func:`index_from_arrays` takes it, its captured
    plan as a ``dict`` of :func:`plan_from_arrays`' arguments (``perm``,
    ``tile_levels``, ``nq``, ``tile``, ``ladder``; None: the next step
    plans afresh), the queries that plan was captured at in external-query
    mode (None in self-query mode), and the session options (a
    ``SessionOpts`` or the ``dict`` of the reference's)."""
    dev = resolve_device(device)
    index = index_from_arrays(points, dense, counts, sat, overflow,
                              anchor_points, origin, spec=spec,
                              params=params, opts=opts, device=dev)
    tplan = None if plan is None else plan_from_arrays(device=dev, **plan)
    aq = (None if anchor_queries is None
          else _tensor(anchor_queries, torch.float32, dev))
    if not isinstance(sopts, SessionOpts):
        sopts = SessionOpts(**(sopts or {}))
    return SimulationSession.from_state(index, sopts, plan=tplan,
                                        anchor_queries=aq)


def _leaf(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True)).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, cfg) -> list:
    """The per-layer subtrees of a reference tree in layer order: the
    ``prefix`` list, each period of the stacked ``body`` slots, the
    ``tail`` list (as ``model._unstack_layers`` in the reference)."""
    groups = layer_groups(cfg)
    out = list(tree.get("prefix", []))
    for pi in range(groups.n_periods):
        for si in range(len(groups.period)):
            out.append(_tree_map(lambda a: np.asarray(a)[pi],
                                 tree["body"][si]))
    return out + list(tree.get("tail", []))


def _is_quantized(v) -> bool:
    return isinstance(v, dict) and "code" in v


def _flatten(tree, prefix: str = "") -> dict:
    """A nested dict as ``{"a.b.c": leaf}``, a list's items named by their
    index (``"a.0.b"``, as an ``nn.ModuleList`` names them: Whisper's
    ``enc.layers`` and ``cross``); a quantized moment (``{"code",
    "scale"}``) is one leaf."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)) and not _is_quantized(v):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_arrays_by_name(cfg, tree) -> dict:
    """A tree shaped as the reference's LM parameters (the parameters, their
    gradients, or one optimizer moment, as numpy arrays) by the port's
    parameter names (``LM.named_parameters()``): the stacked body unstacked
    into ``blocks.<layer>.``, a quantized moment's ``code`` and ``scale``
    unstacked alike and kept together, the lists of an encoder-decoder
    (``enc.layers``, ``cross``; not stacked there) as ``enc.layers.<i>.``
    and ``cross.<i>.``."""
    top = {k: v for k, v in tree.items()
           if k not in ("prefix", "body", "tail")}
    out = _flatten(top)
    for li, layer in enumerate(_unstack(tree, cfg)):
        out.update(_flatten(layer, f"blocks.{li}."))
    return out


def lm_params_from_arrays(cfg, tree, *, device="cuda") -> LM:
    """The port's :class:`LM` holding the reference's parameters: ``tree``
    is the reference's param tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), its stacked body unstacked
    into one block per layer. Dtypes are kept; the parameters do not
    require gradients (``requires_grad_()`` to train)."""
    dev = resolve_device(device)
    state = lm_arrays_by_name(cfg, tree)
    model = init_params(cfg, dtype=torch.float32, device="meta")
    model.load_state_dict({k: _leaf(v, dev) for k, v in state.items()},
                          strict=True, assign=True)
    return model


def opt_state_from_arrays(cfg, tree, *, device="cuda") -> dict:
    """The port's optimizer state (``train.optimizer.init_opt_state``'s
    layout) from the reference's: ``tree`` is its ``{"step", "m", "v"}``
    as numpy arrays, each moment shaped as the param tree (float32 leaves,
    or ``{"code", "scale"}`` when quantized); ``m`` and ``v`` come back by
    the port's parameter names, the step as an int32 0-d tensor."""
    dev = resolve_device(device)

    def moment(tree_m):
        return {name: (_tree_map(lambda a: _leaf(a, dev), v)
                       if _is_quantized(v) else _leaf(v, dev))
                for name, v in lm_arrays_by_name(cfg, tree_m).items()}

    return {"step": _tensor(tree["step"], torch.int32, dev).reshape(()),
            "m": moment(tree["m"]), "v": moment(tree["v"])}


def decode_cache_from_arrays(cfg, tree, *, device="cuda") -> Cache:
    """The port's decode cache (one entry per layer) from the reference's
    ``init_decode_cache``/``decode_step`` cache tree as numpy arrays: an
    attention layer's ``k``, ``v`` (and a ring buffer's ``pos``) as
    tensors, its ``length`` read to a host int."""
    dev = resolve_device(device)

    def layer(entry):
        out = _tree_map(lambda a: _leaf(a, dev), entry)
        if "length" in entry:
            out["length"] = int(np.asarray(entry["length"]))
        return out

    return [layer(entry) for entry in _unstack(tree, cfg)]
