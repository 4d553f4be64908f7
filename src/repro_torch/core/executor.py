"""Device-resident bundle executor of the host-planned search.

The legacy orchestrator (``NeighborSearch._query_host_loop``) runs a
Python loop over bundles with three blocking transfers and a numpy scatter
per bundle, giving back on the host much of what scheduling and
partitioning won on the device. The executor keeps the execution phase on
the device:

* **signature batching**: bundles sharing a launch signature
  ``(w_search, skip_test, padded-N bucket)`` fold into one padded launch,
  so B bundles become about |unique signatures| launches;
* **on-device scatter**: per group, gather the queries, search them and
  scatter the rows through the composed schedule∘partition permutation
  into the three output tensors, all enqueued on the current stream;
* **one wait**: exactly ONE blocking wait per query
  (``PendingResult.wait``). The only other blocking transfer is the *plan
  fetch*: one copy of the per-query ``(w_search, skip, rho)`` that
  data-dependent partitioning needs on the host. Both are counted in
  ``stats()``;
* **plan and launcher caches**: host plans are cached by a value
  fingerprint, launchers by the plan's padded-bucket shape.

Eager PyTorch has no jit: a *launcher* is a Python closure over the
groups' static ``(w_search, skip_test, pad_n)``, cached under the key the
reference's jitted launch schedule had, and ``compilations`` counts the
first-seen keys. What does get built is a kernel's library, on its first
launch (``kernels/build.py``); ``stats()`` reports which are loaded.
"""
from __future__ import annotations

import collections
import functools
import hashlib
import time

import numpy as np
import torch

from .. import obs
from ..reliability import faults
from .bundle import bundle_query_sel
from .partition import (PartitionPlan, compute_megacells,
                        inflate_plan_inputs, plan_partitions, trivial_plan)
from .schedule import schedule_cells
from .types import SearchResult, Tensor

_PLAN_CACHE_MAX = 32
_LAUNCHER_CACHE_MAX = 32


def _fingerprint(*arrays: np.ndarray) -> bytes:
    with obs.span("fingerprint"):
        h = hashlib.sha1()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()


@functools.lru_cache(maxsize=None)
def _wait_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def _wait(event: torch.cuda.Event | None, device: torch.device) -> None:
    """Block until the work recorded by ``event`` is done. A side stream
    that holds only a wait for the event is synchronised: that returns
    when this query's work is done, not later queries' (so dispatched
    batches keep overlapping), and it is a stream synchronisation, which
    ``torch.cuda.set_sync_debug_mode`` reports. On the CPU the work has
    already run."""
    if event is None:
        return
    stream = _wait_stream(device)
    stream.wait_event(event)
    stream.synchronize()


class LaunchGroup:
    """One padded device launch covering every bundle of one signature."""

    __slots__ = ("w_search", "skip_test", "sel", "pad_n", "n_bundles")

    def __init__(self, w_search: int, skip_test: bool, sel: np.ndarray,
                 pad_n: int, n_bundles: int):
        self.w_search = w_search
        self.skip_test = skip_test
        self.sel = sel              # scheduled-order query positions
        self.pad_n = pad_n
        self.n_bundles = n_bundles


class PlanHandle:
    """A captured schedule∘partition∘bundle plan, replayable across frames.

    Produced by ``QueryExecutor.capture_plan`` and replayed with
    ``execute(queries, reuse=handle)``: the handle owns the Morton schedule
    permutation (device), the partition plan and launch groups, and the
    edge-padded per-group selections (device, uploaded once). Replaying
    does no host planning: no schedule, no plan fetch, no partition or
    bundle work, no padding. ``margin`` records the window inflation baked
    into the plan (``partition.inflate_plan_inputs``).
    """

    __slots__ = ("perm", "plan", "bundles", "groups", "sels_dev",
                 "nq", "margin")

    def __init__(self, perm, plan, bundles, groups, sels_dev, nq, margin):
        self.perm = perm
        self.plan = plan
        self.bundles = bundles
        self.groups = groups
        self.sels_dev = sels_dev
        self.nq = nq
        self.margin = margin


class PendingResult:
    """A dispatched query whose result has not been waited for
    (``QueryExecutor.execute_async``).

    Its launches are already enqueued; ``wait()`` makes the one blocking
    wait of the one-sync contract (idempotent: repeated calls return the
    same ``SearchResult``). Deferring the wait lets a caller stage and
    dispatch batch N+1 on the host while batch N runs on the device.
    """

    __slots__ = ("_executor", "_arrays", "_event", "_last", "_sp_query",
                 "_t_launch", "_result")

    def __init__(self, executor, arrays, event, last, sp_query, t_launch):
        self._executor = executor
        self._arrays = arrays
        self._event = event
        self._last = last
        self._sp_query = sp_query
        self._t_launch = t_launch
        self._result: SearchResult | None = None

    def done(self) -> bool:
        return self._result is not None

    def wait(self) -> SearchResult:
        if self._result is None:
            self._result = self._executor._finalize(
                self._arrays, self._event, self._last, self._sp_query,
                self._t_launch)
        return self._result


class QueryExecutor:
    """Executes a ``NeighborSearch``'s bundle plan on the device.

    Owned by the search object (``ns.executor``) and reused across
    queries: a repeated query hits the plan cache and builds nothing.
    Surface: ``execute()`` (called by ``NeighborSearch.query``),
    ``execute_async()``, ``capture_plan()``/``execute(reuse=...)``,
    ``invalidate()``, ``warmup()``, ``stats()``.
    """

    def __init__(self, ns):
        self.ns = ns
        self._plan_cache: collections.OrderedDict = collections.OrderedDict()
        self._launcher_cache: collections.OrderedDict = \
            collections.OrderedDict()
        self._signatures: set = set()
        # totals live in the registry (repro_torch.obs): counters for the
        # caching/sync contract, histograms for latency percentiles
        self._metrics = obs.metric_set("executor")
        self._last: dict = {}

    # -- planning -----------------------------------------------------------

    def _fetch_plan_inputs(self, queries_s: Tensor):
        """The plan fetch: ``(w_search, skip, rho)`` of every scheduled
        query, stacked on the device as 32-bit words and copied to the host
        in ONE blocking transfer."""
        ns = self.ns
        with obs.span("fetch"):
            w, s, r = compute_megacells(ns.grid, queries_s, ns.statics,
                                        ns.params)
            packed = torch.stack([w.to(torch.int32).view(torch.float32),
                                  s.to(torch.int32).view(torch.float32),
                                  r.to(torch.float32)])
            host = packed.cpu().numpy()
        return host[0].view(np.int32), host[1].view(np.int32) != 0, host[2]

    def _plan(self, queries_s: Tensor, margin: int = 0):
        """Fetch the partition metadata (one transfer), then plan and group
        on the host, or reuse a cached plan for this fingerprint.

        ``margin`` inflates every per-query window by that many cells
        (clamped to w_full) before partitioning: the staleness allowance a
        plan captured for reuse carries.
        """
        ns = self.ns
        nq = queries_s.shape[0]
        partitioned = ns.opts.partition and ns.statics.has_megacells

        if partitioned:
            w_np, s_np, r_np = self._fetch_plan_inputs(queries_s)
            self._last["plan_fetches"] += 1
            if margin:
                w_np, s_np = inflate_plan_inputs(
                    w_np, s_np, margin=margin, w_full=ns.statics.w_full,
                    w_sph=ns.statics.w_sph)
            key = (nq, margin, _fingerprint(w_np, s_np, r_np))
        else:
            key = (nq, margin, b"nopart")

        hit = self._plan_cache.get(key)
        if hit is not None:
            self._plan_cache.move_to_end(key)
            self._last["plan_cache_hit"] = True
            return hit

        with obs.span("partition"):
            plan = (plan_partitions(w_np, s_np, r_np, ns.statics.w_full)
                    if partitioned else trivial_plan(nq, ns.statics.w_full))
        with obs.span("bundle"):
            bundles = ns._bundle(plan)
            groups = self._build_groups(plan, bundles)
        self._plan_cache[key] = (plan, bundles, groups)
        if len(self._plan_cache) > _PLAN_CACHE_MAX:
            self._plan_cache.popitem(last=False)
        return plan, bundles, groups

    def _prepare_launch(self, groups):
        """Each group's selection edge-padded to its bucket on the host and
        uploaded from pinned memory without a host synchronisation."""
        dev = self.ns.device
        sels = []
        with obs.span("stage"):
            for g in groups:
                sel = torch.from_numpy(np.pad(
                    g.sel, (0, g.pad_n - g.sel.shape[0]), mode="edge"))
                if dev.type == "cuda":
                    sel = sel.pin_memory()
                sels.append(sel.to(dev, non_blocking=True))
        return tuple(sels)

    def capture_plan(self, queries, *, qcells_dev: Tensor | None = None,
                     margin: int = 0) -> PlanHandle:
        """Schedule + partition + bundle ``queries`` once and freeze the
        result into a replayable :class:`PlanHandle`.

        ``qcells_dev`` optionally supplies the queries' cell coordinates on
        the device; ``margin`` bakes the staleness allowance into every
        window.
        """
        ns = self.ns
        self._last = collections.Counter()    # scratch for _plan's counters
        queries = ns._queries(queries)
        nq = queries.shape[0]
        with obs.span("plan", capture=True, nq=nq, margin=margin) as sp:
            with obs.span("schedule"):
                if not ns.opts.schedule:
                    perm = torch.arange(nq, dtype=torch.int32,
                                        device=queries.device)
                elif qcells_dev is not None:
                    perm, _ = schedule_cells(qcells_dev)
                else:
                    perm, _ = ns._schedule(queries)
                queries_s = queries[perm.long()]
            plan, bundles, groups = self._plan(queries_s, margin=margin)
            sels_dev = self._prepare_launch(groups)
        self._metrics.count("plan_fetches", self._last["plan_fetches"])
        self._metrics.count("plan_captures")
        self._metrics.observe("plan_s", sp.duration)
        return PlanHandle(perm=perm, plan=plan, bundles=bundles,
                          groups=groups, sels_dev=sels_dev, nq=nq,
                          margin=margin)

    def _build_groups(self, plan: PartitionPlan,
                      bundles) -> list[LaunchGroup]:
        """Fold bundles sharing (w_search, skip_test) into one launch."""
        from .search import _pad_bucket

        by_sig: dict = {}
        order: list = []
        for b in bundles:
            sig = b.signature
            if sig not in by_sig:
                by_sig[sig] = []
                order.append(sig)
            by_sig[sig].append(bundle_query_sel(plan, b))
        groups = []
        for sig in order:
            sels = by_sig[sig]
            sel = (sels[0] if len(sels) == 1
                   else np.concatenate(sels)).astype(np.int64)
            groups.append(LaunchGroup(
                w_search=sig[0], skip_test=sig[1], sel=sel,
                pad_n=_pad_bucket(sel.shape[0], self.ns.opts.query_tile),
                n_bundles=len(sels)))
        return groups

    # -- launch schedules ---------------------------------------------------

    def _get_launcher(self, groups, nq: int):
        """The launch schedule of a plan: per group, gather -> padded window
        search -> scatter through the composed schedule∘partition
        permutation. Cached by the plan's *padded-bucket* shape
        ``(w, skip, pad_n)`` per group, not by exact counts or plan values:
        selections are edge-padded to the bucket on the host, so queries
        whose partition counts drift within the same buckets reuse it.
        """
        ns = self.ns
        metas = tuple((g.w_search, g.skip_test, g.pad_n) for g in groups)
        key = (metas, nq, ns.params.k, ns.opts.query_tile,
               ns.opts.use_pallas)
        launcher = self._launcher_cache.get(key)
        if launcher is not None:
            self._launcher_cache.move_to_end(key)
            self._last["launcher_cache_hit"] = True
            return launcher
        faults.maybe_fail("compile")
        self._last["compilations"] += 1
        searcher = ns._searcher()
        spec, radius, k, tile = (ns.spec, ns.params.radius, ns.params.k,
                                 ns.opts.query_tile)
        for g in groups:
            self._signatures.add((g.w_search, g.skip_test, g.pad_n, tile,
                                  k, ns.opts.use_pallas))

        def launcher(grid, points, queries_s, perm, sels, counts,
                     out_idx, out_d2, out_cnt):
            for (w, skip, _pad_n), sel, n in zip(metas, sels, counts):
                # sel arrives edge-padded to the bucket: padded slots repeat
                # the group's last real query. Only the n real rows are
                # scattered: a padded copy can sit in a tile of its own,
                # whose shared window differs from the real query's tile,
                # and in range mode a different window can return a
                # different bounded subset; so no row is written twice
                qb = queries_s[sel]
                idx, d2, cnt = searcher(grid, points, qb, spec, w, radius,
                                        k, skip, tile)
                orig = perm[sel[:n]].long()
                out_idx[orig] = idx[:n]
                out_d2[orig] = d2[:n]
                out_cnt[orig] = cnt[:n]
            return out_idx, out_d2, out_cnt

        self._launcher_cache[key] = launcher
        if len(self._launcher_cache) > _LAUNCHER_CACHE_MAX:
            self._launcher_cache.popitem(last=False)
        return launcher

    # -- execution ----------------------------------------------------------

    def execute(self, queries, *,
                reuse: PlanHandle | None = None) -> SearchResult:
        """Run one query. With ``reuse`` the given captured plan is replayed
        verbatim: no schedule, no plan fetch, no partition or bundle work,
        no padding, only the launches."""
        return self.execute_async(queries, reuse=reuse).wait()

    def execute_async(self, queries, *,
                      reuse: PlanHandle | None = None) -> PendingResult:
        """Plan and dispatch one query WITHOUT the blocking wait.

        Returns a :class:`PendingResult` whose ``wait()`` makes the one
        blocking wait. Every per-call counter rides the pending record, not
        executor state, so several dispatches may be in flight.
        """
        ns = self.ns
        last = dict(host_syncs=0, plan_fetches=0, launches=0,
                    dispatches=0, compilations=0, bundles=0,
                    plan_cache_hit=False, plan_reused=False,
                    launcher_cache_hit=False)
        self._last = last
        queries = ns._queries(queries)
        nq = queries.shape[0]
        k = ns.params.k

        # the top-level query span stays open until the pending result's
        # wait(): plan, launch and sync all nest under it
        sp_query = obs.span("query", nq=nq)
        sp_query.__enter__()
        try:
            # fault-injection seam: a scheduled launch fault fails the
            # dispatch before any device work
            faults.maybe_fail("launch")
            return self._dispatch_pending(queries, nq, k, reuse, last,
                                          sp_query)
        except BaseException:
            sp_query.__exit__(None, None, None)
            raise

    def _dispatch_pending(self, queries, nq, k, reuse, last, sp_query):
        ns = self.ns
        dev = queries.device
        with obs.span("plan", reused=reuse is not None) as sp_plan:
            if reuse is not None:
                if reuse.nq != nq:
                    raise ValueError(f"reused plan was captured for nq="
                                     f"{reuse.nq}, got {nq} queries")
                perm = reuse.perm
                queries_s = queries[perm.long()]
                plan, bundles, groups = (reuse.plan, reuse.bundles,
                                         reuse.groups)
                sels_dev = reuse.sels_dev
                last["plan_reused"] = True
            else:
                with obs.span("schedule"):
                    perm, _inv = ns._schedule(queries)
                    queries_s = queries[perm.long()]
                plan, bundles, groups = self._plan(queries_s)
                sels_dev = self._prepare_launch(groups)
        ns.report.t_opt = sp_plan.duration
        ns.report.num_partitions = plan.num_partitions
        ns.report.bundles = bundles
        last["bundles"] = len(bundles)
        last["launches"] = len(groups)

        t0 = time.perf_counter()
        with obs.span("launch", groups=len(groups)):
            launcher = self._get_launcher(groups, nq)
            t_disp = time.perf_counter()
            arrays = launcher(
                ns.grid, ns.points, queries_s, perm, sels_dev,
                tuple(g.sel.shape[0] for g in groups),
                torch.full((nq, k), -1, dtype=torch.int32, device=dev),
                torch.full((nq, k), float("inf"), dtype=torch.float32,
                           device=dev),
                torch.zeros((nq,), dtype=torch.int32, device=dev))
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            if last["compilations"]:
                # a kernel's first launch builds its library in there
                obs.record_span("compile", time.perf_counter() - t_disp)
        last["dispatches"] = 1
        return PendingResult(self, arrays, event, last, sp_query, t0)

    def _finalize(self, arrays, event, last, sp_query,
                  t_launch) -> SearchResult:
        """The pending result's one blocking wait + metric/report flush."""
        ns = self.ns
        out_idx, out_d2, out_cnt = arrays
        faults.maybe_delay()          # injected straggler: the wait is late
        with obs.span("sync"):
            _wait(event, out_idx.device)
        sp_query.__exit__(None, None, None)
        last["host_syncs"] += 1
        ns.report.t_search = time.perf_counter() - t_launch
        ns.report.launches = last["launches"]
        ns.report.host_syncs = last["host_syncs"]
        ns.report.plan_fetches = last["plan_fetches"]
        self._last = last

        m = self._metrics
        m.count("queries")
        for key in ("launches", "dispatches", "bundles", "host_syncs",
                    "plan_fetches", "compilations"):
            m.count(key, last[key])
        m.count("plan_cache_hits", int(last["plan_cache_hit"]))
        m.count("plan_cache_misses",
                int(not (last["plan_cache_hit"] or last["plan_reused"])))
        m.count("plan_reuses", int(last["plan_reused"]))
        m.count("launcher_cache_hits", int(last["launcher_cache_hit"]))
        m.count("launcher_cache_misses", last["compilations"])
        m.observe("query_s", sp_query.duration)
        m.observe("plan_s", ns.report.t_opt)
        m.gauge("plan_cache_entries", len(self._plan_cache))
        m.gauge("launcher_cache_entries", len(self._launcher_cache))

        return SearchResult(indices=out_idx, distances2=out_d2,
                            counts=out_cnt)

    def invalidate(self) -> None:
        """Drop every cached plan, launcher and signature.

        A respec changes the grid spec that cached launchers close over and
        that every plan was computed against, so the caches are cleared
        wholesale; outstanding ``PlanHandle``s must be discarded by their
        owner."""
        self._plan_cache.clear()
        self._launcher_cache.clear()
        self._signatures.clear()
        self._metrics.count("invalidations")

    # -- surface ------------------------------------------------------------

    def warmup(self, queries) -> dict:
        """Run one query to populate the plan and launcher caches and build
        the kernel's library. Returns stats()."""
        self.execute(queries)
        return self.stats()

    def stats(self) -> dict:
        """Counters for the caching/sync contract.

        ``last`` holds the most recent query's breakdown; ``compilations``
        counts first-seen launcher keys. ``jit_cache_sizes`` keeps the
        reference's key, whose jit caches have no counterpart in eager
        PyTorch: it maps each kernel this path can launch
        (``knn_tile_anchored`` under ``use_pallas``; none on the plain
        path) to whether its library is loaded, so a test can assert that a
        steady-state query builds nothing.
        """
        from ..kernels import build
        sizes = {}
        if self.ns.opts.use_pallas:
            sizes["knn_tile_anchored"] = build.is_loaded("knn_tile_anchored")
        return {
            **self._metrics.counters(),
            "last": dict(self._last),
            "signatures": len(self._signatures),
            "plan_cache_entries": len(self._plan_cache),
            "launcher_cache_entries": len(self._launcher_cache),
            "jit_cache_sizes": sizes,
        }
