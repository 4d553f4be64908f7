#!/usr/bin/env python3
"""Time the port's id-stream kernels (``knn_tile``, ``range_count``) of two
checkouts of this repository on one CUDA card, in turns.

    python3 scripts/stream_kernels_ab.py OLD_TREE NEW_TREE

Each tree is a checkout, for example an older commit unpacked with
``git archive`` into a git-ignored directory. For the trees in the order
old, new, new, old, a fresh process puts the tree's ``src`` first on its
path, builds that tree's kernels, and takes the kernel layer's inputs of
``chip_smoke.py`` (this checkout's): the static knn plan of a 1M-point
KITTI-like scene queried by its own points, its LAYER_WINDOW tiles as id
streams, at 64 tiles and at 4 x the SM count tiles. It times each kernel
by CUDA events (median of 10) and takes a digest of its outputs; the
digests of all runs must agree, so both trees compute the same results.
It also times ``knn_tile_anchored`` on the same tiles and ``api.query`` on
the whole scene (median of 5), the paths a change to the knn kernels'
shared code could move.
Prints one JSON line a run, then a summary line (the card's name and
power limit included). Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = 10


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: str) -> int:
    src = Path(tree).resolve() / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.api as api
    import repro_torch.data as data
    from repro_torch.kernels import ops
    if src not in Path(ops.__file__).resolve().parents:
        raise RuntimeError(f"imported {ops.__file__}, not {src}")
    pts = data.kitti_like_cloud(cs.N_POINTS, seed=1)
    params = api.SearchParams(radius=cs.RADIUS, k=cs.K, knn_window="exact")
    index = api.build_index(pts, params, api.SearchOpts(use_pallas=True))
    queries = index.points.clone()
    plan = api.plan_query(index, queries)
    args, kw, entries = cs.kernel_inputs(index, plan, queries)
    if len(args) > 6:   # the tree's launch takes extents: the ladder's
        args = cs.ladder_inputs(index, plan, args)
    tile = kw["tile"]
    r2 = float(np.float32(cs.RADIUS) * np.float32(cs.RADIUS))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"tree": tree, "query_ms": cs.cuda_time_ms(
        lambda: api.query(index, queries), 5)}
    for n in (cs.N_KERNEL_TILES, 4 * sms):
        lt = cs.layer_tiles(plan, args, kw, entries, index, n)

        def knn():
            return ops.knn_tile(lt["q"], index.points, lt["wnd"], k=cs.K,
                                r2=r2, tile=tile)

        def count():
            return ops.range_count(lt["q"], lt["wnd_pos"], lt["wnd"], r2=r2,
                                   tile=tile)

        sub = [lt["q"], args[1], args[2], lt["anchors"],
               args[4][lt["ids"]].contiguous(), args[5]] + [
                   e[lt["ids"]].contiguous() for e in args[6:]]

        def anchored():
            return ops.knn_tile_anchored(*sub, **kw)

        d2, idx = knn()
        cnt = count()
        d2_a, idx_a = anchored()
        out[f"tiles_{n}"] = {
            "distinct_tiles": lt["distinct"],
            "knn_tile_ms": cs.cuda_time_ms(knn, RUNS),
            "range_count_ms": cs.cuda_time_ms(count, RUNS),
            "knn_tile_anchored_ms": cs.cuda_time_ms(anchored, RUNS),
            "digest": _digest(d2, idx, cnt, d2_a, idx_a)}
        del lt, sub, d2, idx, cnt, d2_a, idx_a
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2])
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:]
    runs = []
    for role, tree in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--worker", tree],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   role=role)
        runs.append(run)
        print(json.dumps(run), flush=True)
    keys = [k for k in runs[0] if k.startswith("tiles_")]
    for k in keys:
        if len({r[k]["digest"] for r in runs}) != 1:
            print(f"stream_kernels_ab: the trees' outputs differ ({k})",
                  file=sys.stderr)
            return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"nvidia_smi": smi, "order": [r["role"] for r in runs],
               "outputs_equal": True}
    summary["query_ms"] = {role: [r["query_ms"] for r in runs
                                  if r["role"] == role]
                           for role in ("old", "new")}
    for k in keys:
        for name in ("knn_tile_ms", "range_count_ms",
                     "knn_tile_anchored_ms"):
            summary[f"{k}_{name}"] = {
                role: [r[k][name] for r in runs if r["role"] == role]
                for role in ("old", "new")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
