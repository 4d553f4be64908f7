#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It builds every hand-written kernel of
the port from ``src/repro_torch/kernels/csrc`` (into ``build/``), holds
each kernel bitwise against its plain PyTorch version, then runs
``repro_torch.api`` on a 1M-point KITTI-like scene queried by its own
points, in knn and in range mode, and checks the result against the
brute-force oracle and the port's CPU planning. Phases print one JSON line
each. The last three lines are the kernel table, the card's name and power
limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (kernel, its source in the repo, the TPU kernel it replaces)
KERNELS = {
    "knn_tile_anchored": ("src/repro_torch/kernels/csrc/knn_tile_anchored.cu",
                          "src/repro/kernels/knn_tile.py:293"),
}
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (query, candidate) pair in knn_tile_anchored: the
# cross product (3 mul + 2 add), qn + pn, 2*cross, the subtraction, the
# clamp at 0 and the radius test
OPS_PER_PAIR = 10

N_POINTS = 1_000_000
RADIUS, K = 0.02, 8        # benchmarks/fig11_speedup.py's KITTI setting
N_SAMPLE = 4096
N_KERNEL_TILES = 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernel_inputs(index, plan, queries):
    """The arguments the main path hands ``knn_tile_anchored`` for this
    index and plan, and the ladder entries its levels index."""
    from repro_torch.kernels import ops
    params = index.params
    args, kw = ops.launch_inputs(
        index.grid, index.points, queries[plan.perm.long()], index.spec,
        plan.ladder, plan.tile_levels, params.radius, params.k, plan.tile)
    return args, kw, ops.segment_levels(plan.ladder, tuple(index.spec.dims))


def compare_kernel(args, kw, tag: str) -> float:
    """Kernel vs plain version on the same inputs; must agree bitwise.
    Returns the max |d2| difference over finite entries (0 when equal)."""
    import torch
    from repro_torch.kernels.knn_tile import (knn_tile_anchored,
                                              knn_tile_anchored_plain)
    d2_k, idx_k = knn_tile_anchored(*args, **kw)
    d2_p, idx_p = knn_tile_anchored_plain(*args, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(d2_p)
    err = float((d2_k[fin] - d2_p[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p),
          f"kernel differs from its plain version ({tag}): "
          f"max |d2| err {err}")
    return err


def phase_kernel_vs_plain(api, data) -> float:
    """Bitwise kernel-vs-plain on the small ``_scene`` workload and a
    KITTI-like 100k-point scene, for k in {1, 5, 8, 32, 100}, both sphere-
    test settings, with every 7th tile moved off the table (neutral)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    scenes = {
        "scene": (rng.random((1500, 3)).astype(np.float32),
                  rng.random((397, 3)).astype(np.float32), 0.11, 128),
        "kitti100k": (data.kitti_like_cloud(100_000, seed=2),
                      data.kitti_like_cloud(20_000, seed=3), 0.02, 256),
    }
    worst = 0.0
    for name, (pts, qs, radius, tile) in scenes.items():
        for k in (1, 5, 8, 32, 100):
            params = api.SearchParams(radius=radius, k=k, knn_window="exact")
            opts = api.SearchOpts(use_pallas=True, query_tile=tile)
            index = api.build_index(pts, params, opts)
            q = torch.from_numpy(qs).cuda()
            plan = api.plan_query(index, q)
            args, kw, _ = kernel_inputs(index, plan, q)
            off = args[4].clone()
            off[::7] = -1
            args[4] = off
            for skip in (0, 1):
                table = args[5].clone()
                table[:, 3] = skip
                worst = max(worst, compare_kernel(
                    args[:5] + [table], kw, f"{name} k={k} skip={skip}"))
            emit("kernel_vs_plain", scene=name, k=k, n_tiles=int(
                args[3].shape[0]), bitwise=True)
    return worst


def phase_main(api, ref, knn_mod, index, queries, mode: str):
    """One run of the main path, counted and under sync-debug "error",
    then its checks. Returns what the kernel table needs."""
    import numpy as np
    import torch
    params = index.params
    torch.cuda.synchronize()
    knn_mod.knn_tile_anchored.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = api.plan_query(index, queries)
        res = api.execute_plan(index, queries, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = knn_mod.knn_tile_anchored.launches
    check(launches >= 1, f"{mode}: the main path launched no kernel")

    # card planning vs the port's CPU planning on the same inputs
    pts_cpu, q_cpu = index.points.cpu(), queries.cpu()
    cindex = api.build_index(pts_cpu, params, index.opts, device="cpu")
    cplan = api.plan_query(cindex, q_cpu)
    spec = index.spec
    check(torch.equal(spec.cell_of(index.points).cpu(),
                      spec.cell_of(pts_cpu)), f"{mode}: cell coords differ")
    for name in ("dense", "counts", "sat", "overflow"):
        check(torch.equal(getattr(index.grid, name).cpu(),
                          getattr(cindex.grid, name)),
              f"{mode}: grid.{name} differs from the CPU build")
    check(cplan.ladder == plan.ladder, f"{mode}: ladder differs")
    check(torch.equal(plan.perm.cpu(), cplan.perm), f"{mode}: perm differs")
    check(torch.equal(plan.tile_levels.cpu(), cplan.tile_levels),
          f"{mode}: tile_levels differ")
    args, kw, entries = kernel_inputs(index, plan, queries)
    cargs, _, _ = kernel_inputs(cindex, cplan, q_cpu)
    check(torch.equal(args[4].cpu(), cargs[4]), f"{mode}: plevel differs")
    check(torch.equal(args[3].cpu(), cargs[3]), f"{mode}: anchors differ")

    # sampled exactness against brute force on the card
    rng = np.random.default_rng(7)
    sample = torch.from_numpy(rng.choice(queries.shape[0], N_SAMPLE,
                                         replace=False)).cuda()
    oi, od, oc = ref.brute_force_search(index.points, queries[sample],
                                        params.radius, params.k, chunk=256)
    check(torch.equal(oc, res.counts[sample]), f"{mode}: counts differ "
          "from brute force")
    d2 = res.distances2[sample]
    check(torch.equal(torch.isinf(od), torch.isinf(d2)),
          f"{mode}: inf masks differ from brute force")
    fin = torch.isfinite(d2)
    err = float((od[fin] - d2[fin]).abs().max()) if fin.any() else 0.0
    idx = res.indices[sample]
    valid = idx >= 0
    pos = index.points[idx.clamp_min(0).long()]
    rec = ((queries[sample][:, None] - pos) ** 2).sum(-1)
    check(bool((rec[valid] - d2[valid]).abs().max() <= 1e-5),
          f"{mode}: an index does not reproduce its distance")
    if mode == "knn":
        check(err <= 1e-6, f"knn: d2 off brute force by {err}")
    else:
        check(bool((d2[valid] <= np.float32(params.radius) ** 2).all()),
              "range: an index lies outside the radius")

    # kernel vs plain on tiles sampled across every level
    plevel = args[4]
    levels_present = sorted(set(plevel.tolist()))
    per = max(1, N_KERNEL_TILES // len(levels_present))
    picks = []
    for lvl in levels_present:
        ids = torch.nonzero(plevel == lvl).flatten()
        gen = torch.Generator().manual_seed(lvl)
        pick = torch.randperm(ids.numel(), generator=gen)[:per]
        picks.append(ids[pick.to(ids.device)])
    tiles = torch.cat(picks)[:N_KERNEL_TILES]
    tile = kw["tile"]
    rows = (tiles[:, None] * tile + torch.arange(tile, device=tiles.device)
            ).flatten()
    sub = [args[0][rows].contiguous(), args[1], args[2],
           args[3][tiles].contiguous(), args[4][tiles].contiguous(), args[5]]
    kerr = compare_kernel(sub, kw, f"{mode} main-path tiles")

    # the bound: valid (query, candidate) pairs and the bytes moved
    from repro_torch.core.grid import box_count
    ws = args[5][plevel.long(), :3]
    hi = torch.minimum(args[3] + ws - 1,
                       torch.tensor([d - 1 for d in spec.dims],
                                    device=ws.device, dtype=torch.int32))
    valid_cands = box_count(index.grid.sat, args[3], hi).to(torch.int64)
    slots = (ws.to(torch.int64).prod(-1) * spec.capacity)
    pairs = int(valid_cands.sum()) * tile
    slot_pairs = int(slots.sum()) * tile
    n_rows = args[0].shape[0]
    nbytes = (args[0].numel() * 4 + args[1].numel() * 4
              + args[2].numel() * 4 + args[3].numel() * 4
              + args[4].numel() * 4 + args[5].numel() * 4
              + n_rows * params.k * 8)
    ops_ms = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    level_tiles = {str(entries[lvl]): int((plevel == lvl).sum())
                   for lvl in levels_present}
    emit("main_path", mode=mode, n_points=int(index.points.shape[0]),
         n_queries=int(queries.shape[0]), dims=list(spec.dims),
         capacity=spec.capacity, w_full=index.statics.w_full,
         ladder=[list(e) for e in plan.ladder], n_tiles=int(plevel.numel()),
         tiles_per_level=level_tiles, launches=launches,
         planned_and_executed_ms=wall_ms, sync_free=True,
         sampled=N_SAMPLE,
         brute_force_max_abs_d2_err=err if mode == "knn" else None,
         mean_count=float(res.counts.float().mean()),
         kernel_tiles_checked=int(tiles.numel()), kernel_max_abs_err=kerr,
         valid_pairs=pairs, slot_pairs=slot_pairs, bytes=nbytes,
         bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms)
    return dict(args=args, kw=kw, launches=launches, err=kerr,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as api
    import repro_torch.data as data
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import knn_tile as knn_mod

    smi = smi_line()
    t0 = time.perf_counter()
    reports = build.build(list(KERNELS))
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, out in reports.items()}
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)

    worst = phase_kernel_vs_plain(api, data)
    emit("kernel_vs_plain_done", max_abs_err=worst, bitwise=True)

    pts = data.kitti_like_cloud(N_POINTS, seed=1)
    opts = api.SearchOpts(use_pallas=True)
    out = {}
    for mode in ("knn", "range"):
        params = (api.SearchParams(radius=RADIUS, k=K, knn_window="exact")
                  if mode == "knn" else
                  api.SearchParams(radius=RADIUS, k=K, mode="range"))
        index = api.build_index(pts, params, opts)
        queries = index.points.clone()
        out[mode] = phase_main(api, ref, knn_mod, index, queries, mode)
        if mode == "knn":
            query_ms = cuda_time_ms(lambda: api.query(index, queries), 5)
            knn_index, knn_queries = index, queries

    # kernel and plain-version times at the main path's shapes
    m = out["knn"]
    kernel_ms = cuda_time_ms(
        lambda: knn_mod.knn_tile_anchored(*m["args"], **m["kw"]), 10)
    plain_ms = cuda_time_ms(
        lambda: knn_mod.knn_tile_anchored_plain(*m["args"], **m["kw"]), 3,
        warmup=0)
    src, replaces = KERNELS["knn_tile_anchored"]
    emit("kernels", kernels=[{
        "name": "knn_tile_anchored", "replaces": replaces,
        "launches": m["launches"], "bitwise": m["err"] == 0.0,
        "ms": kernel_ms}], query_ms=query_ms,
        queries_per_s=knn_queries.shape[0] / query_ms * 1e3,
        n_points=int(knn_index.points.shape[0]))
    print(json.dumps({"kernels": [{
        "name": "knn_tile_anchored", "route": "cuda", "source": src,
        "replaces": replaces, "launches": m["launches"],
        "max_abs_err": m["err"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
