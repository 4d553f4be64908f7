"""Find the benchmark's parts by name.

Everything that belongs to one configuration, one cell, one driven call or
one metric sits in a file of its own under ``portbench/``:

    configs/<config>.json      sizes and guarantees of a deployment
    workloads/<cell>.json      configuration, entry, traffic parameters
    entries/<entry>.py         one driven call of the port (class ``Entry``)
    metrics/<metric>.py        the reader of one metric (``read(run)``)

``BENCHMARK.json`` at the checkout's root says which metrics a cell
reports. A later cell, configuration or metric is a new file and a new
entry there; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]          # portbench/
BENCH_FILE = ROOT.parent / "BENCHMARK.json"
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _path(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def names(kind: str, root: Path = ROOT) -> list[str]:
    """The names of every ``kind`` (configs, workloads, entries, metrics)
    found under ``root``."""
    suffix = ".py" if kind in ("entries", "metrics") else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(
        f"*{suffix}") if NAME_RE.match(p.name[:-len(suffix)]))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def workload(name: str, root: Path = ROOT) -> dict:
    return load_json(_path(root, "workloads", name, ".json"))


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(_path(root, "configs", name, ".json"))


def _module(kind: str, name: str, root: Path):
    path = _path(root, kind, name, ".py")
    modname = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, root: Path = ROOT):
    """The module ``entries/<name>.py``; its ``Entry`` drives the port."""
    return _module("entries", name, root)


def metric(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``; its ``read(run)`` gives the value
    or None where the run holds nothing to read."""
    return _module("metrics", name, root)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics that ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones. A metric with a ``workloads`` key is
    reported in those cells; a per-layer metric without one in every cell
    that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
