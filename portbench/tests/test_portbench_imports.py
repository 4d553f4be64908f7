"""What the benchmark's modules and a traced run of each entry load, in a
fresh interpreter: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the port and
allowed), and the reference modules load nothing of the port."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

LOAD_ALL = """
import importlib, json, sys
sys.path[:0] = [{repo!r}, {src!r}]
import runpy
runpy.run_path({run!r}, run_name="portbench_run")
runpy.run_path({control!r}, run_name="portbench_control")
from portbench.harness import registry
for mod in ("cell", "check", "generators", "readers", "reference",
            "registry", "trace", "work"):
    importlib.import_module("portbench.harness." + mod)
for name in registry.names("entries"):
    registry.entry(name)
for name in registry.names("metrics"):
    registry.metric(name)
# what a run of each entry loads, at a tiny size on the CPU
from portbench.harness import cell
for wl in ("kitti1m-knn8-query", "kitti1m-knn8-planned",
           "sph1m-range32-coherent"):
    cell.run_cell(wl, 1, 0.01, True, device="cpu",
                  overrides={{"n_points": 500, "radius": 0.1, "grid": {{
                      "cell_size": 0.05, "capacity": 8, "margin_radii": 1}}}},
                  workload_overrides={{"warmup_steps": 1}})
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = """
import json, sys
sys.path[:0] = [{repo!r}, {src!r}]
import portbench.harness.check, portbench.harness.generators
import portbench.harness.reference, portbench.harness.work
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code.format(
            repo=str(REPO), src=str(REPO / "src"),
            run=str(REPO / "portbench" / "run.py"),
            control=str(REPO / "portbench" / "control.py"))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_every_benchmark_module_loads_no_jax():
    tops = _tops(_modules(LOAD_ALL))
    assert "repro_torch" in tops     # the entries drive the port
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_modules_load_nothing_of_the_port():
    tops = _tops(_modules(LOAD_REFERENCE))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
