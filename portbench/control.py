#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's own size.

    python portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 3

For each seed, in one process: set-up, a short window at the cell's own
load, then the comparison of the kept calls' answers with the reference
(the program's readings) and, on the same calls and rows, of the
reference computed in bfloat16 in the program's place (the control's
readings). Prints one JSON line a seed. The benchmark's own runs do not
run this; the limits in ``harness/check.py`` were set from its readings.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
for path in (CHECKOUT / "src", CHECKOUT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import cell
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.run_cell(args.workload, seed, args.seconds, False,
                            control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": out["checks"], "program_correct": out["correct"],
            "control": out["_control"],
            "control_correct": out["_control_correct"],
            "rows": out["_rows"], "kinds": out["_kinds_checked"],
            "attempted": out["attempted"],
            "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
