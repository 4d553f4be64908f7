"""How ``correct`` is decided: the answers that the timed calls returned,
on rows sampled from the seed, against the plain reference.

Every number is an exact comparison, so every limit is 0: the program and
the reference compute the same float32 arithmetic, and a sound run reads
0 on each (see ``PERF.md`` for the readings the limits were set from).
"""
from __future__ import annotations

import torch

from . import reference

LIMITS = {"count_rows_off": 0, "slots_off": 0, "knn_d2_gap": 0.0}


def compare_kept(kept: list, config: dict, control: bool = False) -> dict:
    """Compare each kept call's answers on its compared rows with the
    reference. ``kept`` holds objects with ``points``, ``queries``,
    ``rows`` (the compared rows' positions among the queries), ``result``
    (indices, distances2 and counts of those rows) and ``kind``.
    ``control`` puts the reference computed in bfloat16 in the program's
    place. Returns the numbers, summed over the calls (the gap: the
    largest), the rows compared and the kinds."""
    radius, k, mode = config["radius"], config["k"], config["mode"]
    total = {name: 0 for name in LIMITS if mode == "knn"
             or name != "knn_d2_gap"}
    checked, kinds = 0, {}
    for call in kept:
        q = call.queries[call.rows]
        if control:
            idx, d2, cnt = reference.control_rows(call.points, q, radius, k,
                                                  mode)
        else:
            res = call.result
            idx, d2, cnt = res.indices, res.distances2, res.counts
        got = reference.compare_rows(call.points, q, idx, d2, cnt, radius,
                                     k, mode)
        for name, value in got.items():
            total[name] = (max(total[name], value) if name == "knn_d2_gap"
                           else total[name] + value)
        checked += q.shape[0]
        kinds[call.kind] = kinds.get(call.kind, 0) + 1
    return dict(numbers=total, rows=checked, kinds=kinds)


def verdict(numbers: dict) -> dict:
    """Each number beside its limit, in the result line's form."""
    return {name: {"value": value, "limit": LIMITS[name]}
            for name, value in numbers.items()}


def passed(numbers: dict) -> bool:
    return all(value <= LIMITS[name] for name, value in numbers.items())
