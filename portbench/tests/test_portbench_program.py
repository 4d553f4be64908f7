"""The readers of what the program reports about itself
(``harness/program.py``) on synthetic runs: the per-call means of its own
spans, and the fused kernel's pair yield from its walk counter; None,
never 0, where the program records nothing."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness import cell, registry  # noqa: E402
from repro_torch import obs  # noqa: E402

SPAN_METRICS = {
    "fetch_ms.planned": "query/plan/fetch",
    "fingerprint_ms.planned": "query/plan/fingerprint",
    "partition_ms.planned": "query/plan/partition",
    "bundle_ms.planned": "query/plan/bundle",
    "stage_ms.planned": "query/plan/stage",
    "plan_host_ms.query": "query/plan",
}
YIELD_METRICS = ("pair_yield.query", "pair_yield.planned", "pair_yield.step",
                 "pair_yield.cfl")


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(mode="off")
    obs.reset()
    yield
    obs.configure()
    obs.reset()


def _run(n_calls=4, hooked=(1,)):
    run = cell.Run(cell="c", config={"n_points": 1000}, workload={},
                   setup_s=0.0)
    run.stamps = [100.0 + i for i in range(n_calls)]
    run.t_end = 100.0 + n_calls
    run.infos = [{"host_hooks": True} if i in hooked else {}
                 for i in range(n_calls)]
    return run


def _record(path, t0_s, dur_s):
    """A span record of ``path`` as the program leaves it in the ring."""
    parent, _, name = path.rpartition("/")
    opened = [obs.span(p) for p in parent.split("/")] if parent else []
    for sp in opened:
        sp.__enter__()
    obs.record_span(name, dur_s, t0_s=t0_s)
    for sp in reversed(opened):
        sp.__exit__(None, None, None)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_the_mean_over_untraced_calls(metric):
    path = SPAN_METRICS[metric]
    run = _run()
    read = registry.metric(metric).read
    assert read(run) is None                  # nothing recorded
    _record(path, 99.5, 0.5)                  # set-up, before the window
    _record(path, 100.2, 0.002)               # call 0: 4 ms in three parts
    _record(path, 100.5, 0.001)
    _record(path, 100.6, 0.001)
    _record(path, 101.1, 0.009)               # call 1 ran under the profiler
    _record(path, 103.9, 0.005)               # call 3
    _record(path + "/child", 103.95, 0.5)     # another path
    assert read(run) == pytest.approx(4.5)


def test_span_metric_without_calls_is_none():
    run = _run(n_calls=0)
    _record("query/plan", 1.0, 0.001)
    assert registry.metric("plan_host_ms.query").read(run) is None


@pytest.mark.parametrize("metric", YIELD_METRICS)
def test_pair_yield_from_the_walk_counter(metric, monkeypatch):
    run = _run()
    read = registry.metric(metric).read
    assert read(run) is None                  # an untraced run: no work
    run.work = [{"pairs": 6000}, {"pairs": 10000}]
    assert read(run) is None                  # no launch on a card
    walk = {"query_rows": 1024, "candidate_pairs": 1024 * 200}
    monkeypatch.setattr(obs, "kernel_counters",
                        lambda: {"knn_tile_anchored": walk})
    # 8 pairs a query needed against 200 compared a row
    assert read(run) == pytest.approx(4.0)
    run.work = [{"pairs": 0}]
    assert read(run) is None


def test_pair_yield_of_a_program_without_the_counter(monkeypatch):
    run = _run()
    run.work = [{"pairs": 6000}]
    monkeypatch.delattr(obs, "kernel_counters")
    assert registry.metric("pair_yield.query").read(run) is None
