"""``correct`` on the CPU at a size a test run holds: a sound run of each
cell comes out correct, and its control (the reference in bfloat16 in the
program's place) and every fault that the cell can have come out not
correct. The harness's look for a card is skipped (``run_cell`` on
``device="cpu"``); the rest of a run is driven with the timed path broken
underneath."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness import cell  # noqa: E402

# small sizes: the radius and the cells grow with the thinner cloud so
# rows still hold several neighbors
SMALL_SPH = {"n_points": 1500, "radius": 0.1,
             "grid": {"cell_size": 0.025, "capacity": 8, "margin_radii": 1.0}}
SMALL = {
    "kitti1m-knn8-query": ({"n_points": 2000}, {}),
    "kitti1m-knn8-planned": ({"n_points": 2000}, {}),
    "sph1m-range32-coherent": (SMALL_SPH, {"warmup_steps": 2}),
    "sph1m-range32-cfl": (SMALL_SPH, {"warmup_steps": 2}),
}
SESSION = ("sph1m-range32-coherent", "sph1m-range32-cfl")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(name, control=False, seed=2**31 + 3):
    cfg, wl = SMALL[name]
    return cell.run_cell(name, seed, 0.05, False, device="cpu",
                         overrides=cfg, workload_overrides=wl,
                         control=control)


def _half_left_out(res):
    """Half of the rows left out: their slots padded, their counts 0."""
    n = res.counts.shape[0] // 2
    idx, d2, cnt = (res.indices.clone(), res.distances2.clone(),
                    res.counts.clone())
    idx[n:] = -1
    d2[n:] = float("inf")
    cnt[n:] = 0
    return dataclasses.replace(res, indices=idx, distances2=d2, counts=cnt)


def _altered(res):
    """An answer altered where it is produced: each row's first index
    moved to the next point."""
    idx = res.indices.clone()
    n = idx.shape[0]
    idx[:, 0] = torch.where(idx[:, 0] >= 0, (idx[:, 0] + 1) % n, idx[:, 0])
    return dataclasses.replace(res, indices=idx)


def _break(monkeypatch, name, fault):
    """Break the timed path of ``name``'s entry with ``fault``."""
    from repro_torch.core import api, dynamic, search
    if name == "kitti1m-knn8-query":
        target, attr = api, "execute_plan"
    elif name == "kitti1m-knn8-planned":
        target, attr = search.NeighborSearch, "query"
    else:
        target, attr = dynamic.SimulationSession, "step"
    orig = getattr(target, attr)
    last = {}

    def broken(*args, **kwargs):
        if fault == "unchanged" and "res" in last:
            return last["res"]
        res = orig(*args, **kwargs)
        last["res"] = res
        if fault == "half":
            return _half_left_out(res)
        if fault == "altered":
            return _altered(res)
        return res

    monkeypatch.setattr(target, attr, broken)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["_rows"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_in_bfloat16_is_not_correct(name):
    out = _run(name, control=True)
    assert out["correct"]
    assert not out["_control_correct"]
    assert out["_control"]["slots_off"]["value"] > 0


FAULTS = [(n, f) for n in sorted(SMALL) for f in ("half", "altered")] + [
    (n, "unchanged") for n in ("kitti1m-knn8-planned", *SESSION)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, name, fault)
    out = _run(name)
    assert not out["correct"], (fault, out["checks"])
