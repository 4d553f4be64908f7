"""The benchmark's harness on the CPU: discovery by name, the contract's
limits on ``BENCHMARK.json``, the trace reduction, and a run that finds
no card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness import cell, registry, trace  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            yield group, item["name"]


@pytest.mark.parametrize("group,name", list(_all_names()))
def test_names_use_allowed_characters(group, name):
    assert registry.NAME_RE.match(name), (group, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert registry.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert (REPO / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        layer = metric["layer"]
        assert 1 <= len(layer) <= 200 and "\n" not in layer
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_benchmark_file_shape():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= cells <= 24
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith("portbench/")
        data = json.loads((REPO / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]
        assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_what_the_contract_asks(wl):
    name = wl["name"]
    data = registry.workload(name)
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == wl[key]
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    registry.config(wl["config"])
    registry.entry(data["entry"])
    e2e = [m["name"] for m in registry.cell_metrics(BENCH, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.cell_metrics(BENCH, name, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_a_dropped_in_cell_config_and_metric_are_found(tmp_path):
    """A new cell is a new workload file, configuration file and metric
    file, with entries in BENCHMARK.json: nothing else is edited."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "kitti-1m.json").read_text())
    cfg.update(name="kitti-tiny", n_points=1500)
    (root / "configs" / "kitti-tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "kitti1m-knn8-query.json")
                    .read_text())
    wl.update(name="kitti-tiny-query", config="kitti-tiny")
    (root / "workloads" / "kitti-tiny-query.json").write_text(json.dumps(wl))
    (root / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(len(run.stamps))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({k: wl[k] for k in ("name", "config", "traffic",
                                                  "chips", "why")})
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "Device", "moves": "query_rate",
        "workloads": ["kitti-tiny-query"]})
    for m in bench["end_to_end"]:
        if m["name"] == "query_rate":
            m["workloads"].append("kitti-tiny-query")
    assert "kitti-tiny-query" in registry.names("workloads", root)
    assert "kitti-tiny" in registry.names("configs", root)
    assert "calls_in_window" in registry.names("metrics", root)
    for p, data in before.items():
        assert p.read_bytes() == data, p
    out = cell.run_cell("kitti-tiny-query", 5, 0.05, True, device="cpu",
                        bench=bench, root=root)
    assert out["correct"]
    assert out["metrics"]["calls_in_window"]["value"] >= 1


def test_no_card_exits_nonzero_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path),
               TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kitti1m-knn8-query", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert "repro.fake_sub" in cell.forbidden_modules()


def test_trace_reduce_busy_idle_and_gaps():
    ms = 1_000_000
    events = [
        (trace.WINDOW, "span", 0, 100 * ms),
        ("portbench.call", "span", 0, 50 * ms),
        ("sync", "span", 30 * ms, 50 * ms),
        ("portbench.call", "span", 50 * ms, 100 * ms),
        ("k_a", "device", 5 * ms, 30 * ms),
        ("k_b", "device", 20 * ms, 35 * ms),
        ("k_a", "device", 60 * ms, 95 * ms),
        ("outside", "device", 120 * ms, 130 * ms),
    ]
    out = trace.reduce(events)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.065)
    assert out["ops"]["k_a"] == (pytest.approx(0.060), 2)
    assert "outside" not in out["ops"]
    gaps = dict(out["idle_gaps"])
    # 0-5 ms in the first call, 35-60 in sync (mid 47.5), 95-100 in the
    # second call
    assert gaps["portbench.call"] == pytest.approx(0.010)
    assert gaps["sync"] == pytest.approx(0.025)
    assert trace.kernel_seconds(out, "k_") == (pytest.approx(0.075), 3)


def test_trace_reduce_of_the_device_alone_takes_the_slices_length():
    ms = 1_000_000
    events = [("k_a", "device", 10 * ms, 30 * ms),
              ("k_b", "device", 50 * ms, 60 * ms)]
    out = trace.reduce(events, window_s=0.1)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.03)
    assert dict(out["idle_gaps"]) == {"(none)": pytest.approx(0.07)}
    with pytest.raises(ValueError):
        trace.reduce(events)


class _Result:
    def __init__(self, n, tag):
        self.indices = torch.full((n, 2), tag, dtype=torch.int32)
        self.distances2 = torch.full((n, 2), float(tag))
        self.counts = torch.arange(n, dtype=torch.int32)


def test_keeper_is_a_seeded_reservoir_per_kind():
    def fill(seed):
        keeper = cell.Keeper(2, 5, np.random.default_rng(seed),
                             np.random.default_rng(seed + 1))
        q = torch.zeros(40, 3)
        for i in range(50):
            keeper.offer(cell.Call(result=_Result(40, i), points=q,
                                   queries=q, kind="a" if i % 3 else "b"))
        return keeper.kept()
    assert [int(c.result.indices[0, 0]) for c in fill(1)] == \
        [int(c.result.indices[0, 0]) for c in fill(1)]
    got = fill(1)
    tags = [int(c.result.indices[0, 0]) for c in got]
    assert len(got) == 4
    assert sum(t % 3 != 0 for t in tags) == 2
    # a kept call holds only its compared rows of the answer
    for c in got:
        assert c.rows.shape == (5,) and len(set(c.rows.tolist())) == 5
        assert c.result.indices.shape == (5, 2)
        assert torch.equal(c.result.counts, c.rows.to(torch.int32))


def test_tracer_profiles_two_slices_of_the_window(monkeypatch):
    """The quiet slice records the device alone and the named slice the
    host's spans too, each between its shares of the window; the calls
    of the named slice are known, so their host times can be left out."""
    import torch.profiler as tp
    made = []

    class FakeProfile:
        def __init__(self, activities):
            self.activities = activities
            made.append(self)

        def start(self):
            self.on = True

        def stop(self):
            self.on = False

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(tp, "profile", FakeProfile)
    tracer = cell.Tracer(10.0)
    for i in range(101):
        tracer.before_call(i, i * 0.1)
    tracer.close(101)
    assert [len(p.activities) for p in made] == [1, 2]
    assert made[0].activities == [tp.ProfilerActivity.CUDA]
    assert not any(p.on for p in made)
    quiet, named = tracer.slices["quiet"], tracer.slices["named"]
    assert (quiet["first"], quiet["calls"]) == (20, 40)
    assert (named["first"], named["calls"]) == (70, 20)
    assert tracer.profiled(19) is None and tracer.profiled(20) == "quiet"
    assert tracer.profiled(89) == "named" and tracer.profiled(90) is None


def test_host_times_leave_out_the_calls_with_host_hooks():
    from portbench.harness import readers
    run = cell.Run(cell="c", config={}, workload={}, setup_s=0.0)
    run.infos = [{"t": 1.0}, {"t": 9.0, "host_hooks": True}, {"t": 3.0}]
    assert readers.mean_info(run, "t") == 2.0


def test_idle_share_is_read_at_the_untraced_pace():
    from portbench.harness import readers
    run = cell.Run(cell="c", config={}, workload={}, setup_s=0.0)
    assert readers.idle_share(run) is None
    # 10 calls busy 2 s in all on the device, untraced calls of 0.25 s
    run.profile = {"busy_s": 2.0, "window_s": 3.0, "calls": 10,
                   "untraced_call_s": 0.25}
    assert readers.idle_share(run) == pytest.approx(20.0)
    run.profile["untraced_call_s"] = None
    assert readers.idle_share(run) is None
