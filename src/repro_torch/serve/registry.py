"""Scene registry: LRU of device-resident scenes keyed by scene id (the
reference's ``serve/registry.py`` on PyTorch).

A serving process holds many tenants' scenes but bounded device memory, so
residency is explicit: a :class:`SceneRegistry` keeps at most ``capacity``
scenes resident on its ``device``, each a :class:`SceneRecord` owning the
host points and one :class:`SceneVariant` per search signature
``(SearchParams, SearchOpts)``, the unit the micro-batcher buckets
requests by. A variant owns a built ``NeighborSearch`` (functional
``NeighborIndex`` + the host-planned ``QueryExecutor`` with its plan and
launcher caches), so evicting the scene releases the executor caches
(``executor.invalidate()``) along with the variant's state. Eviction fires
registered callbacks so the service can fail or re-route in-flight
requests for the evicted tenant.

The reference gives each variant a private ``jax.jit`` of ``api.query``
and counts its compile cache. Eager PyTorch has no such cache: a variant's
``fn`` is a plain call of ``api.query``, and ``compiled_programs()`` counts
the launch buckets it has served (the reference's own fallback), so
"compiled" means "this bucket's first launch".

Live :class:`~repro_torch.core.SimulationSession` scenes register too
(``add_session``): their variant serves queries against the session's
*current* index, read under the session's step lock (``variant.lock``).
"""
from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from .. import obs
from ..core import api
from ..core.search import NeighborSearch, _pad_bucket
from ..core.types import SearchOpts, SearchParams


class SceneVariant:
    """One scene under one search signature: the serving unit.

    ``index`` is the functional index the drained launches run against;
    ``fn`` the serve call (``api.query``); ``searcher`` the host-planned
    surface over the same tensors (its executor caches are the per-scene
    cache handles the registry invalidates on evict).
    """

    __slots__ = ("params", "opts", "searcher", "session", "fn", "warmed",
                 "_quality")

    def __init__(self, params: SearchParams, opts: SearchOpts, *,
                 searcher: NeighborSearch | None = None, session=None):
        self.params = params
        self.opts = opts
        self.searcher = searcher
        self.session = session
        self.fn = api.query
        self.warmed: set[int] = set()
        self._quality: tuple[int, int] | None = None

    @property
    def index(self) -> api.NeighborIndex:
        if self.session is not None:
            return self.session.index
        return self.searcher.index

    @property
    def device(self) -> torch.device:
        return self.index.device

    def lock(self):
        """The context to hold from reading ``index`` through the last
        launch on it: a session-backed variant's step lock (a step may
        re-bin into the storage of the frame being read), else nothing."""
        if self.session is not None:
            return self.session.lock
        return contextlib.nullcontext()

    def pad_to_bucket(self, n: int) -> int:
        """Padded launch size for ``n`` concatenated queries (power-of-two
        multiple of the query tile — the executor's bucket discipline)."""
        return _pad_bucket(n, self.opts.query_tile)

    def warm(self, nq: int) -> int:
        """Serve one dummy launch of the ``nq``-query bucket (building the
        kernel library on the card's first call) and wait for it; returns
        the padded bucket size. Idempotent per bucket."""
        pad_n = self.pad_to_bucket(nq)
        if pad_n not in self.warmed:
            with self.lock():
                index = self.index
                self.fn(index, torch.zeros((pad_n, 3), dtype=torch.float32,
                                           device=index.device))
            if index.device.type == "cuda":
                torch.cuda.synchronize(index.device)
            self.warmed.add(pad_n)
        return pad_n

    def quality_counters(self) -> tuple[int, int]:
        """``(overflow, oob)`` device quality counters for responses served
        off this variant. A static scene's grid is frozen after build, so
        its overflow scalar is fetched ONCE (a blocking transfer) and
        cached; a session-backed scene reads the host-side counters its
        packed step telemetry already published for the current frame."""
        if self.session is not None:
            rep = self.session.report
            return int(rep.overflow), int(rep.oob)
        if self._quality is None:
            self._quality = (int(self.searcher.index.grid.overflow), 0)
        return self._quality

    def compiled_programs(self) -> int:
        """Launch buckets this variant has served (tests assert re-warm
        after eviction/readmission through this)."""
        return len(self.warmed)

    def release(self) -> None:
        """Drop the variant's state: executor plan/launcher caches and the
        served buckets."""
        if self.searcher is not None:
            self.searcher.executor.invalidate()
        self.fn = None
        self.warmed.clear()


class SceneRecord:
    """One resident scene: the host points plus its signature variants,
    built on ``device``."""

    __slots__ = ("scene_id", "points", "spec", "session", "device",
                 "_variants")

    def __init__(self, scene_id, points=None, *, device: torch.device,
                 spec=None, session=None):
        self.scene_id = scene_id
        self.session = session
        self.spec = spec
        self.device = device
        if session is not None:
            self.points = None
        else:
            self.points = np.asarray(points, np.float32)
        self._variants: dict = {}

    def variant(self, params: SearchParams,
                opts: SearchOpts = SearchOpts()) -> SceneVariant:
        """Get-or-build the scene's variant for one search signature."""
        key = (params, opts)
        v = self._variants.get(key)
        if v is not None:
            return v
        if self.session is not None:
            if params != self.session.params:
                raise ValueError(
                    f"scene {self.scene_id!r} is session-backed with params "
                    f"{self.session.params}; cannot serve {params}")
            v = SceneVariant(params, opts, session=self.session)
        else:
            v = SceneVariant(params, opts, searcher=NeighborSearch(
                self.points, params, opts, spec=self.spec,
                device=self.device))
        self._variants[key] = v
        return v

    def variants(self):
        return list(self._variants.values())

    def release(self) -> None:
        for v in self._variants.values():
            v.release()
        self._variants.clear()


class SceneRegistry:
    """LRU of resident :class:`SceneRecord`\\ s, explicit capacity, on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``get``/``resolve`` touch the entry (most-recently-used); ``add_*``
    past capacity evicts the least-recently-used scene — releasing its
    executor caches and served buckets and firing every ``on_evict``
    callback with ``(scene_id, record)``.
    """

    def __init__(self, capacity: int = 8, *, device="cuda"):
        if capacity < 1:
            raise ValueError("registry capacity must be >= 1")
        self.capacity = int(capacity)
        self.device = api.resolve_device(device)
        self._records: collections.OrderedDict = collections.OrderedDict()
        self._callbacks: list = []
        self._lock = threading.RLock()
        self._metrics = obs.metric_set("serve_registry")

    # -- membership ---------------------------------------------------------

    def on_evict(self, callback) -> None:
        """Register ``callback(scene_id, record)`` to fire on eviction."""
        self._callbacks.append(callback)

    def add_scene(self, scene_id, points, *, spec=None) -> SceneRecord:
        """Admit (or replace) a static scene; evicts LRU past capacity."""
        return self._admit(SceneRecord(scene_id, points, spec=spec,
                                       device=self.device))

    def add_session(self, scene_id, session) -> SceneRecord:
        """Admit a live ``SimulationSession`` as a dynamic scene."""
        return self._admit(SceneRecord(scene_id, session=session,
                                       device=session.index.device))

    def _admit(self, rec: SceneRecord) -> SceneRecord:
        with self._lock:
            old = self._records.pop(rec.scene_id, None)
            if old is not None:
                old.release()
            self._records[rec.scene_id] = rec
            self._metrics.count("admissions")
            while len(self._records) > self.capacity:
                lru_id = next(iter(self._records))
                self._evict_locked(lru_id)
            self._metrics.gauge("resident_scenes", len(self._records))
        return rec

    def evict(self, scene_id) -> None:
        with self._lock:
            self._evict_locked(scene_id)
            self._metrics.gauge("resident_scenes", len(self._records))

    def _evict_locked(self, scene_id) -> None:
        rec = self._records.pop(scene_id)
        rec.release()
        self._metrics.count("evictions")
        for cb in self._callbacks:
            cb(scene_id, rec)

    def clear(self) -> None:
        with self._lock:
            for scene_id in list(self._records):
                self._evict_locked(scene_id)
            self._metrics.gauge("resident_scenes", 0)

    # -- lookup -------------------------------------------------------------

    def __contains__(self, scene_id) -> bool:
        with self._lock:
            return scene_id in self._records

    def __len__(self) -> int:
        return len(self._records)

    def get(self, scene_id) -> SceneRecord:
        """Fetch + LRU-touch; ``KeyError`` when not resident."""
        with self._lock:
            rec = self._records[scene_id]
            self._records.move_to_end(scene_id)
            return rec

    def resolve(self, scene_id, params: SearchParams,
                opts: SearchOpts = SearchOpts()) -> SceneVariant:
        """``get`` + get-or-build the signature variant (the drain path)."""
        return self.get(scene_id).variant(params, opts)

    def scene_ids(self) -> list:
        with self._lock:
            return list(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {
                **self._metrics.counters(),
                "resident_scenes": len(self._records),
                "capacity": self.capacity,
                "variants": sum(len(r._variants)
                                for r in self._records.values()),
            }
