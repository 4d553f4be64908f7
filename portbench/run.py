#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown. The last line of standard output is one JSON object;
the numbers that decide ``correct`` are also the last lines of standard
error, each beside its limit. Exits non-zero, printing no result, without
a CUDA card (or with fewer than the cell asks for), and when a module of
JAX or of the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches live at fixed paths inside the
# checkout, so only a checkout's first run builds
BUILD = CHECKOUT / "build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
for path in (CHECKOUT / "src", CHECKOUT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.harness import cell, registry
    wl = registry.workload(args.workload)
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device="cuda", t_start=T_START)
    # checked once the window has closed, in the process that prints
    found = cell.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are "
              f"loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    notes = {k[1:]: out.pop(k) for k in list(out) if k.startswith("_")}
    print(f"portbench: {args.workload} seed {args.seed}: "
          f"{json.dumps(notes)}", file=sys.stderr)
    print("portbench: no module of jax, jaxlib, flax or repro is loaded",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
