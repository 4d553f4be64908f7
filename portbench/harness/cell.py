"""One run of one cell: set-up, the measured window, the reading of the
metrics and the comparison with the reference, as one result line.

The loop is closed: each call of the entry follows the previous one's
return. The window opens at the first call and closes in a device
synchronise after the first call that starts ``seconds`` or more after
it. With ``trace`` two steady slices of the window run under
``torch.profiler`` (``Tracer``); the rest of it runs untraced.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time

import torch

from . import check, generators, registry, trace as trace_mod, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced slices, as shares of the window: ``quiet`` records the
# device's operations alone, ``named`` the host's spans besides
QUIET = (0.2, 0.6)
NAMED = (0.7, 0.9)


@dataclasses.dataclass
class Call:
    """One driven call: its result (``indices``, ``distances2``,
    ``counts``), the points and queries it searched, its kind (replay,
    replan, respec, call) and what the program reported about it. A kept
    call holds only its compared ``rows`` of the result."""

    result: object
    points: torch.Tensor
    queries: torch.Tensor
    kind: str = "call"
    info: dict = dataclasses.field(default_factory=dict)
    rows: torch.Tensor | None = None


@dataclasses.dataclass
class Rows:
    """The compared rows of a call's result."""

    indices: torch.Tensor
    distances2: torch.Tensor
    counts: torch.Tensor


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    cell: str
    config: dict
    workload: dict
    setup_s: float
    t0: float = 0.0
    t_end: float = 0.0
    stamps: list = dataclasses.field(default_factory=list)
    units: list = dataclasses.field(default_factory=list)
    infos: list = dataclasses.field(default_factory=list)
    profile: dict | None = None
    work: list | None = None

    @property
    def durations(self) -> list[float]:
        """Each call from its start to the next call's start, the last to
        the window's closing synchronise."""
        ends = self.stamps[1:] + [self.t_end]
        return [b - a for a, b in zip(self.stamps, ends)]

    def kernel_seconds(self, part: str) -> tuple[float, int]:
        return trace_mod.kernel_seconds(self.profile, part)


class Keeper:
    """A reservoir of up to ``per_kind`` calls of each kind, drawn from
    ``rng``: the calls whose answers are compared once the window has
    closed. A call is cut to ``rows`` of its queries, drawn from
    ``rows_rng``, as it is kept, so only those rows of its answer stay
    alive through the window (its points and queries stay whole)."""

    def __init__(self, per_kind: int, rows: int, rng, rows_rng):
        self.per_kind, self.rows = per_kind, rows
        self.rng, self.rows_rng = rng, rows_rng
        self.seen: dict = {}
        self.slots: dict = {}

    def _cut(self, call: Call) -> Call:
        nq = call.queries.shape[0]
        pick = self.rows_rng.choice(nq, min(self.rows, nq), replace=False)
        sel = torch.as_tensor(pick, device=call.queries.device)
        res = call.result
        return dataclasses.replace(call, rows=sel, result=Rows(
            res.indices[sel], res.distances2[sel], res.counts[sel]))

    def offer(self, call: Call) -> None:
        n = self.seen.get(call.kind, 0)
        self.seen[call.kind] = n + 1
        slots = self.slots.setdefault(call.kind, [])
        if len(slots) < self.per_kind:
            slots.append(self._cut(call))
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.per_kind:
                slots[j] = self._cut(call)

    def kept(self) -> list[Call]:
        return [c for kind in sorted(self.slots) for c in self.slots[kind]]


class Tracer:
    """Profiles two steady slices of a traced window on a card, each
    opened and closed before a call, after a device synchronise:

    - ``quiet`` (``QUIET``) records the device's operations alone: busy
      time, kernel times and the top operations come from it. The
      profiler still hooks each launch on the host (about 5 ms a call of
      ``api.query``, measured on an H100), so the idle share is read
      from the untraced calls' pace (``untraced_call_s``);
    - ``named`` (``NAMED``) records the host's spans besides, and names
      each idle gap of the device by the span open in it. Its hooks slow
      the host more, so no other number is read from it.

    The host times that the per-layer metrics read leave out the calls
    of both slices.
    """

    def __init__(self, seconds: float):
        self.todo = [("quiet", QUIET), ("named", NAMED)]
        self.seconds = seconds
        self.open = None
        self.slices: dict = {}

    def before_call(self, i: int, elapsed: float) -> None:
        if self.open and elapsed >= self.open["end"] * self.seconds:
            self.close(i)
        if (not self.open and self.todo
                and elapsed >= self.todo[0][1][0] * self.seconds):
            self._start(i, *self.todo.pop(0))

    def _start(self, i: int, name: str, bounds) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CUDA]
        if name == "named":
            acts.append(ProfilerActivity.CPU)
        torch.cuda.synchronize()
        prof = profile(activities=acts)
        prof.start()
        span = None
        if name == "named":
            span = record_function(trace_mod.WINDOW)
            span.__enter__()
        self.open = dict(name=name, end=bounds[1], prof=prof, span=span,
                         first=i, t0=time.perf_counter())

    def close(self, i: int) -> None:
        """Close the open slice before call ``i`` (or at the window's
        end)."""
        if not self.open:
            return
        torch.cuda.synchronize()
        s = self.open
        s["window_s"] = time.perf_counter() - s.pop("t0")
        if s["span"] is not None:
            s.pop("span").__exit__(None, None, None)
        s["prof"].stop()
        s["calls"] = i - s["first"]
        self.slices[s.pop("name")] = s
        self.open = None

    def profiled(self, i: int) -> str | None:
        """The slice that call ``i`` ran in, if any."""
        for name, s in self.slices.items():
            if s["first"] <= i < s["first"] + s["calls"]:
                return name
        return None

    def reduce(self) -> dict | None:
        """The quiet slice's reduction (``trace.reduce``), its calls, and
        the named slice's idle gaps; None without a quiet slice."""
        quiet = self.slices.get("quiet")
        if not quiet or not quiet["calls"]:
            return None
        events = trace_mod.kineto_events(quiet.pop("prof"))
        if not any(kind == "device" for _n, kind, _a, _b in events):
            return None
        out = trace_mod.reduce(events, window_s=quiet["window_s"])
        out["calls"] = quiet["calls"]
        named = self.slices.get("named")
        out["named_idle_gaps"], out["named_idle_share"] = [], None
        if named and named["calls"]:
            red = trace_mod.reduce(trace_mod.kineto_events(
                named.pop("prof")))
            out["named_idle_gaps"] = red["idle_gaps"]
            out["named_idle_share"] = 100.0 * (
                1 - red["busy_s"] / red["window_s"])
        return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _untraced_call_s(run: Run, tracer: Tracer, touched: set):
    """The mean duration of the calls outside both slices (and not next
    to a slice's start or end); None if there are none."""
    free = [d for j, d in enumerate(run.durations)
            if j not in touched and tracer.profiled(j) is None]
    return statistics.fmean(free) if free else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None,
             workload_overrides: dict | None = None, control: bool = False,
             bench: dict | None = None, root=registry.ROOT) -> dict:
    """Run cell ``name`` and return its result line as a dict.

    ``t_start`` is the process's start on ``time.perf_counter``'s clock
    (set-up is counted from it). ``overrides`` replaces configuration
    keys and ``workload_overrides`` workload keys (tests run at small
    sizes); ``control`` also compares, on the same calls and rows, the
    reference computed in bfloat16 in the program's place (``_control``).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    wl = dict(registry.workload(name, root), **(workload_overrides or {}))
    cfg = dict(registry.config(wl["config"], root), **(overrides or {}))
    bench = bench if bench is not None else registry.load_json(
        registry.BENCH_FILE)
    wanted = registry.cell_metrics(bench, name, trace)
    ent = registry.entry(wl["entry"], root).Entry(cfg, wl, seed, device,
                                                  trace)
    ent.warmup()
    _sync(device)
    run = Run(cell=name, config=cfg, workload=wl,
              setup_s=time.perf_counter() - t_start)
    keeper = Keeper(int(wl["keep_per_kind"]), int(wl["check_rows"]),
                    generators.rng(seed, 1), generators.rng(seed, 2))
    failed = 0
    errors = []
    on_card = torch.device(device).type == "cuda"
    tracer = Tracer(seconds) if trace and on_card else None
    touched = set()
    if trace:
        from torch.profiler import record_function
    else:
        def record_function(_name):
            return contextlib.nullcontext()
    run.t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        if i and t - run.t0 >= seconds:
            break
        if tracer is not None:
            was = len(tracer.slices), tracer.open is not None
            tracer.before_call(i, t - run.t0)
            if (len(tracer.slices), tracer.open is not None) != was:
                touched.add(i - 1)
            t = time.perf_counter()
        run.stamps.append(t)
        try:
            with record_function("portbench.call"):
                call = ent.call(i)
        # a call that raises is counted, and the run is not correct
        except Exception as exc:
            failed += 1
            errors.append(repr(exc))
            run.units.append(0)
            run.infos.append({})
        else:
            run.units.append(ent.units)
            run.infos.append(call.info)
            keeper.offer(call)
        i += 1
    _sync(device)
    run.t_end = time.perf_counter()
    if tracer is not None:
        tracer.close(i)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ent.close()
    kept = keeper.kept()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    notes = {}
    if tracer is not None:
        # host times of calls that ran with the profiler's hooks are left out
        for j, info in enumerate(run.infos):
            if tracer.profiled(j) is not None:
                info["host_hooks"] = True
        run.profile = tracer.reduce()
        if run.profile:
            run.profile["untraced_call_s"] = _untraced_call_s(run, tracer,
                                                              touched)
            dev["busy_s"] = run.profile["busy_s"]
            dev["window_s"] = run.profile["window_s"]
            breakdown = {"device_ops": run.profile["device_ops"],
                         "idle_gaps": run.profile["named_idle_gaps"]}
            p = run.profile
            notes = {"traced_calls": p["calls"],
                     "idle_quiet_slice": 100.0 * (
                         1 - p["busy_s"] / p["window_s"]),
                     "idle_named_slice": p["named_idle_share"],
                     "call_ms_quiet_slice": 1e3 * p["window_s"] / p["calls"],
                     "call_ms_untraced": (
                         None if p["untraced_call_s"] is None
                         else 1e3 * p["untraced_call_s"])}
        del tracer
    if trace:
        counted: dict = {}
        run.work = []
        for c in kept:
            key = (id(c.points), id(c.queries))
            if key not in counted:
                counted[key] = work.call_work(c.points, c.queries,
                                              cfg["radius"], cfg["k"],
                                              cfg["mode"])
            run.work.append(counted[key])
    got = check.compare_kept(kept, cfg)
    if control:
        control = check.compare_kept(kept, cfg, control=True)
    del kept, keeper
    metrics = {}
    for m in wanted:
        value = registry.metric(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run.stamps)
    correct = (attempted > 0 and failed == 0 and got["rows"] > 0
               and check.passed(got["numbers"]))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = check.verdict(got["numbers"])
    out["_rows"] = got["rows"]
    out["_kinds_checked"] = got["kinds"]
    out["_errors"] = errors[:3]
    out.update({"_" + k: v for k, v in notes.items()})
    if control:
        out["_control"] = check.verdict(control["numbers"])
        out["_control_correct"] = check.passed(control["numbers"])
    return out
