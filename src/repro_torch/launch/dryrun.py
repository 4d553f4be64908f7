"""Dry run of every (arch x shape x mesh) cell on the meta device (the port
of ``src/repro/launch/dryrun.py``).

For each cell it builds the parameters (bfloat16, as the reference's
``PARAM_DTYPE``), the optimizer state (int8 moments above 3e10
parameters), the batch and the decode cache on the meta device (shapes
and dtypes, nothing allocated), places them by ``sharding.rules`` on the
production mesh of a fake process group (``make_production_mesh``: 256
ranks, or 512 for two pods, in this one process), and records:

  * the specs; ``static_bytes_per_device`` (parameters, optimizer state or
    cache, exact under the specs) and ``analytic_peak_bytes`` (static +
    the reference's activation model), ``n_micro`` / ``b_micro``,
    ``param_profile`` and ``model_flops_global``, each as the reference
    computes it;
  * FLOPs: ``FlopCounterMode`` over one microbatch's forward and backward
    (remat's recompute included), one prefill, or one decode step, run on
    the meta device, times ``n_micro``, plus the reference's analytic
    optimizer term (20 FLOPs a parameter). Every op is counted where it
    runs, so no layer probe or trip-count composition is needed (the
    reference's XLA counts a loop body once). ``rwkv_scan``'s recurrence
    is not counted (its meta branch propagates shapes only), as the
    reference's probe leaves out its scan;
  * bytes accessed: :class:`hlo_analysis.OpBytes`, each op's inputs and
    outputs summed on the meta device, an unfused upper bound (plus the
    reference's optimizer term, twice the static bytes);
  * per device = global / chips, an even split;
  * collectives: one step on DTensors (the parameters, batch, optimizer
    state or cache placed by their specs on the meta device), counted by
    kind with result bytes per device (``hlo_analysis.count_collectives``;
    :func:`collectives_by_periods` composes them from the model cut to one
    and two periods); the roofline's collective term is those bytes over
    the H100's NVLink rate (``hlo_analysis.LINK_BW``), and its dominant
    term is taken over compute, memory and collectives, on both meshes.
    A serving step that cannot run on DTensors records null with the
    first line of the error that stopped it; a train step's error fails
    the cell.

Nothing happens at import. ``main()`` starts the fake process group once,
from ``torch.testing._internal.distributed.fake_pg`` (an internal module
of PyTorch, imported here alone; the run stops if it is missing).

Usage (the CPU suffices; no card is needed):
  python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
One JSON a cell is written under ``build/dryrun/`` (``--out-dir``); an
existing one is reused unless ``--force``. Exits 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import ALL_ARCHS, SHAPES, applicable
from ..configs.shapes import ShapeSpec
from ..data.pipeline import batch_specs
from ..models.config import ArchConfig, get_config, list_configs
from ..models.model import (count_params, decode_step, init_decode_cache,
                            init_params, train_forward)
from ..sharding.rules import (batch_axes, batch_pspec, cache_pspecs,
                              mesh_shape, opt_pspecs, param_pspecs,
                              placements)
from ..train.optimizer import OptConfig, opt_state_specs
from ..train.serve_step import make_prefill_step
from . import hlo_analysis as H
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
PARAM_DTYPE = torch.bfloat16
MESH_WORLD = {"pod": 256, "multipod": 512}


@functools.lru_cache(maxsize=None)
def _n_params(cfg: ArchConfig) -> int:
    return count_params(cfg)


def microbatching(cfg: ArchConfig, shape: ShapeSpec, mesh
                  ) -> tuple[int, int]:
    """(n_micro, per-micro global batch) for train cells: B_local scales
    inversely with parameter count to bound activation memory."""
    axes = mesh_shape(mesh)
    n_b = math.prod(axes[a] for a in batch_axes(axes))
    params_b = _n_params(cfg) / 1e9
    b_local = 1 if params_b > 50 else (4 if params_b > 5 else 16)
    b_micro = min(shape.global_batch, n_b * b_local)
    while shape.global_batch % b_micro:
        b_micro -= n_b
    n_micro = shape.global_batch // b_micro
    return n_micro, b_micro


def hbm_budget() -> float:
    """The serving profile's weight + cache budget: 13/16 of the card's
    memory (the share the reference leaves of its chip's), the H100's
    80 GB where no card is present."""
    total = (torch.cuda.get_device_properties(0).total_memory
             if torch.cuda.is_available() else H.HBM_BYTES)
    return total * 13 / 16


def _profile_for(params: dict, shape: ShapeSpec, mesh,
                 cache_bytes: int = 0, *, budget: float | None = None
                 ) -> str:
    """Serving profile: weights replicated over "data" when the
    model-sharded copy plus the sharded cache fits ``budget`` (default
    :func:`hbm_budget`), which saves the per-token FSDP all-gathers;
    FSDP otherwise, recorded in the cell."""
    if shape.kind not in ("decode", "prefill"):
        return "train"
    budget = hbm_budget() if budget is None else budget
    w = H.sharded_bytes(params, param_pspecs(params, mesh, "serve"), mesh)
    return "serve" if w + cache_bytes < budget else "train"


def model_flops_global(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N*D for train (N = active params, D = tokens/step); 2*N*D for one
    decoded token per sequence; 2*N*D over prompt tokens for prefill."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        seq = min(shape.seq_len, cfg.max_target_len) if cfg.enc_dec \
            else shape.seq_len
        return 6.0 * n_active * shape.global_batch * seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def _serve_batch(cfg: ArchConfig, b: int, s: int) -> dict:
    batch = batch_specs(cfg, b, s)
    batch.pop("labels", None)
    batch.pop("mask", None)
    return batch


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               budget: float | None = None) -> tuple[dict, dict]:
    """Returns (objects, meta): the cell's meta-device parameters
    (``params``), optimizer state (``opt``), decode cache (``cache``),
    batch and their specs; and ``meta`` as the reference's
    (``static_bytes_per_device`` exact under the specs,
    ``analytic_peak_bytes`` adding the activation model)."""
    model = init_params(cfg, dtype=PARAM_DTYPE, device="meta")
    params = dict(model.named_parameters())
    objs: dict = {"model": model, "params": params}
    cache_bytes = 0
    if shape.kind == "decode":
        cache = init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                  PARAM_DTYPE, device="meta")
        objs["cache"] = cache
        objs["cache_specs"] = cache_pspecs(cache, mesh, shape.global_batch)
        cache_bytes = H.sharded_bytes(cache, objs["cache_specs"], mesh)
    profile = _profile_for(params, shape, mesh, cache_bytes, budget=budget)
    objs["param_specs"] = param_pspecs(params, mesh, profile)
    static = H.sharded_bytes(params, objs["param_specs"], mesh)

    if shape.kind == "train":
        n_micro, b_micro = microbatching(cfg, shape, mesh)
        opt_cfg = OptConfig(quantize_moments=_n_params(cfg) > 3e10)
        objs["opt"] = opt_state_specs(params, opt_cfg)
        objs["opt_specs"] = opt_pspecs(objs["opt"], mesh)
        static += H.sharded_bytes(objs["opt"], objs["opt_specs"], mesh)
        objs["batch"] = batch_specs(cfg, b_micro, shape.seq_len)
        meta = {"n_micro": n_micro, "b_micro": b_micro,
                "quantized_opt": opt_cfg.quantize_moments}
    elif shape.kind == "prefill":
        objs["batch"] = _serve_batch(cfg, shape.global_batch, shape.seq_len)
        meta = {}
    else:
        objs["batch"] = _serve_batch(cfg, shape.global_batch, 1)
        static += cache_bytes
        meta = {"cache_len": shape.seq_len}
    objs["batch_specs"] = {k: batch_pspec(mesh, v.shape[0], v.dim() - 1)
                           for k, v in objs["batch"].items()}
    meta["param_profile"] = profile
    meta["static_bytes_per_device"] = int(static)
    meta["analytic_peak_bytes"] = int(
        static + H.analytic_activation_bytes(cfg, shape, mesh, meta))
    return objs, meta


def count_step(cfg: ArchConfig, shape: ShapeSpec, objs: dict
               ) -> tuple[float, float]:
    """(FLOPs, bytes accessed) of one microbatch's forward and backward
    (train, remat on), one prefill or one decode step, run on the meta
    device under ``FlopCounterMode`` and :class:`hlo_analysis.OpBytes`."""
    from torch.utils.flop_counter import FlopCounterMode

    model, batch = objs["model"], objs["batch"]
    flops, op_bytes = FlopCounterMode(display=False), H.OpBytes()
    with flops, op_bytes:
        if shape.kind == "train":
            model.requires_grad_(True)
            train_forward(model, batch, cfg, remat=True).backward()
            model.requires_grad_(False)
        elif shape.kind == "prefill":
            make_prefill_step(cfg)(model, batch)
        else:
            with torch.no_grad():
                decode_step(model, objs["cache"], batch["tokens"], cfg,
                            pos=batch.get("pos3"))
    return float(flops.get_total_flops()), float(op_bytes.bytes)


def collectives_by_periods(cfg: ArchConfig, shape: ShapeSpec, mesh,
                           meta: dict) -> dict:
    """The collectives of one step of the cell on DTensors
    (:func:`count_sharded_step`), composed from the model cut to one and
    to two of its periods (prefix and tail kept): every period places
    and runs alike, so a step's count is the one-period count plus the
    difference times the remaining periods, per kind, as the reference
    composes its per-program costs with trip counts. A model of two
    periods or fewer runs whole. DTensor's eager dispatch costs about
    100 us an operation here, which a whole 32-layer step at 256 ranks
    turns into minutes."""
    import dataclasses

    from ..models.model import layer_groups

    def count(c: ArchConfig) -> dict:
        objs, _ = build_cell(c, shape, mesh)
        # the whole model's serving profile, moment format and microbatch,
        # which the cut's size could change
        objs["param_specs"] = param_pspecs(objs["params"], mesh,
                                           meta["param_profile"])
        if shape.kind == "train":
            objs["opt"] = opt_state_specs(objs["params"], OptConfig(
                quantize_moments=meta["quantized_opt"]))
            objs["opt_specs"] = opt_pspecs(objs["opt"], mesh)
            objs["batch"] = batch_specs(c, meta["b_micro"], shape.seq_len)
            objs["batch_specs"] = {
                k: batch_pspec(mesh, v.shape[0], v.dim() - 1)
                for k, v in objs["batch"].items()}
        return count_sharded_step(c, shape, objs, mesh, meta)

    groups = layer_groups(cfg)
    if groups.n_periods <= 2:
        return count(cfg)
    fixed = len(groups.prefix_kinds) + len(groups.tail_kinds)
    one, two = (count(dataclasses.replace(
        cfg, n_layers=fixed + k * len(groups.period))) for k in (1, 2))
    more = groups.n_periods - 1

    def per_kind(key):
        return {k: one[key].get(k, 0)
                + more * (two[key].get(k, 0) - one[key].get(k, 0))
                for k in sorted(set(one[key]) | set(two[key]))}

    return {"counts": per_kind("counts"),
            "per_kind_bytes": per_kind("per_kind_bytes"),
            "total_bytes": one["total_bytes"]
            + more * (two["total_bytes"] - one["total_bytes"]),
            "comm_debug_total": one["comm_debug_total"]
            + more * (two["comm_debug_total"] - one["comm_debug_total"]),
            "composed_from_periods": [1, 2]}


def count_sharded_step(cfg: ArchConfig, shape: ShapeSpec, objs: dict,
                       mesh, meta: dict) -> dict:
    """The collectives of one step on DTensors: the cell's parameters,
    batch, optimizer state or cache placed on ``mesh`` by their specs
    (meta tensors, the fake process group), then, counted by
    :func:`hlo_analysis.count_collectives`, one microbatch's forward and
    backward (remat on, times ``n_micro``) and the optimizer update, one
    prefill, or one decode step. Raises where the step cannot run on
    DTensors (the message names the operation)."""
    from ..models.model import scanned_params
    from ..sharding.rules import (make_shard_fn, place_parameters,
                                  place_tree)
    from ..train.optimizer import apply_updates
    from ..train.train_step import replicating

    model = place_parameters(objs["model"], mesh, objs["param_specs"])
    batch = place_tree(objs["batch"], mesh, objs["batch_specs"])
    shard = make_shard_fn(mesh)
    named = dict(model.named_parameters())
    with replicating(named.values()):
        if shape.kind == "train":
            opt = place_tree(objs["opt"], mesh, objs["opt_specs"])
            model.requires_grad_(True)
            try:
                _, fwd_bwd = H.count_collectives(lambda: train_forward(
                    model, batch, cfg, shard=shard, remat=True).backward())
                grads = {n: p.grad for n, p in named.items()}
                opt_cfg = OptConfig(quantize_moments=meta["quantized_opt"])
                _, update = H.count_collectives(lambda: apply_updates(
                    named, grads, opt, opt_cfg,
                    stacked=scanned_params(model)))
            finally:
                model.requires_grad_(False)
            return H.add_collectives(
                H.scale_collectives(fwd_bwd, meta["n_micro"]), update)
        with torch.no_grad():
            if shape.kind == "prefill":
                return H.count_collectives(lambda: make_prefill_step(
                    cfg, shard=shard)(model, batch))[1]
            cache = place_tree(objs["cache"], mesh, objs["cache_specs"])
            return H.count_collectives(lambda: decode_step(
                model, cache, batch["tokens"], cfg, pos=batch.get("pos3"),
                shard=shard))[1]


def _dtensor_param_bytes(objs: dict, mesh) -> int:
    """Rank 0's local bytes of every parameter placed on ``mesh`` as a
    DTensor by its spec (meta tensors, nothing allocated): the placements
    held to the spec arithmetic of ``sharded_bytes``."""
    from torch.distributed.tensor import distribute_tensor

    total = 0
    for name, p in objs["params"].items():
        local = distribute_tensor(p.detach(), mesh, placements(
            objs["param_specs"][name], mesh)).to_local()
        total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             force: bool = False, out_dir: Path = OUT_DIR) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{mesh_name}__{arch}__{shape_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, reason = applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": reason})
        out_path.write_text(json.dumps(record, indent=1))
        return record

    try:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        chips = math.prod(mesh_shape(mesh).values())
        t0 = time.perf_counter()
        objs, meta = build_cell(cfg, shape, mesh)
        placed = _dtensor_param_bytes(objs, mesh)
        param_bytes = H.sharded_bytes(objs["params"], objs["param_specs"],
                                      mesh)
        if placed != param_bytes:
            raise RuntimeError(f"DTensor placement holds {placed} bytes of "
                               f"parameters on rank 0, the specs "
                               f"{param_bytes}")
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        flops, op_bytes = count_step(cfg, shape, objs)
        t_count = time.perf_counter() - t0
        t0 = time.perf_counter()
        coll, coll_reason = None, None
        try:
            coll = collectives_by_periods(cfg, shape, mesh, meta)
        except Exception as e:
            if shape.kind == "train":
                raise
            coll_reason = f"{H.COLLECTIVES_NOT_COUNTED}: {_first_line(e)}"
        t_coll = time.perf_counter() - t0
        n_params = _n_params(cfg)
        if shape.kind == "train":
            n_micro = meta["n_micro"]
            flops_dev = (n_micro * flops + 20.0 * n_params) / chips
            bytes_dev = (n_micro * op_bytes / chips
                         + 2.0 * meta["static_bytes_per_device"])
        else:
            flops_dev, bytes_dev = flops / chips, op_bytes / chips
        cost = {"flops": flops_dev, "bytes accessed": bytes_dev}
        terms = H.roofline(cost, coll, chips=chips,
                           model_flops_global=model_flops_global(cfg, shape))
        record.update({
            "status": "ok",
            "chips": chips,
            "meta": meta,
            "build_s": round(t_build, 2),
            "count_s": round(t_count, 2),
            "collectives_s": round(t_coll, 2),
            "memory": H.memory_summary(meta),
            "param_bytes_rank0_dtensor": placed,
            "specs": {
                "batch": {k: list(v) for k, v in
                          objs["batch_specs"].items()},
                "params": len(objs["param_specs"]),
                "params_sharded": sum(any(e is not None for e in s)
                                      for s in objs["param_specs"].values()),
            },
            "step_counts": {"flops": flops, "bytes_accessed": op_bytes,
                            "bytes_note": "each op's inputs and outputs, "
                            "unfused: an upper bound"},
            "cost_per_device": cost,
            "collectives": coll,
            "collectives_reason": coll_reason,
            "roofline": terms.to_dict(),
            "roofline_device": "NVIDIA H100 SXM5 80GB (data sheet rates)",
            "param_count": n_params,
            "active_param_count": cfg.active_param_count(),
        })
    except Exception as e:  # a cell's failure is recorded, the run goes on
        record.update({"status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
        print(f"[{mesh_name}|{arch}|{shape_name}] FAILED: {e}", flush=True)
    out_path.write_text(json.dumps(record, indent=1))
    return record


def _first_line(e: Exception) -> str:
    """An exception as ``Type: its message's first line``."""
    msg = str(e).strip().splitlines()
    return f"{type(e).__name__}: {msg[0] if msg else ''}"


def _summary(r: dict) -> str:
    """One cell's line: status, and for an ``ok`` cell its static bytes
    and analytic peak per device, FLOPs per device and dominant term."""
    line = f"{r['mesh']:8s} {r['arch']:22s} {r['shape']:12s} {r['status']}"
    if r["status"] != "ok":
        return line
    meta, terms = r["meta"], r["roofline"]
    return (f"{line} static={meta['static_bytes_per_device']} "
            f"peak={meta['analytic_peak_bytes']} "
            f"flops/dev={terms['flops_per_device']:.4e} "
            f"dominant={terms['dominant']}")


def _init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (rank 0):
    collectives are no-ops, meshes and DTensor placements are real."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise SystemExit(
            "dryrun: PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg) is missing from "
            f"this installation: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="one registered config (--all: the ten of "
                    "ALL_ARCHS); " + ", ".join(sorted(list_configs())))
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where each cell's JSON goes (build/dryrun)")
    args = ap.parse_args(argv)

    if args.arch is not None and args.arch not in list_configs():
        ap.error(f"unknown --arch {args.arch!r}")
    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    _init_fake_group(max(MESH_WORLD[m] for m in meshes))

    results = []
    t0 = time.perf_counter()
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                r = run_cell(arch, shape_name, mesh_name, force=args.force,
                             out_dir=Path(args.out_dir))
                print(_summary(r), flush=True)
                results.append(r)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\ndry-run cells: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors, {time.perf_counter() - t0:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
