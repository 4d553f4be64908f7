"""Sharded scenes on real ranks (``launch/mesh.py`` rank layouts,
``core/shards.py``'s rank-to-rank exchange): 8 gloo CPU processes,
spawned once for the file (a ``FileStore`` under a temporary directory,
loopback only, one intra-op thread each), each running every case and
writing its results. The reference's multi-slab results come from one
subprocess under 8 forced host devices (``_shard_cases.py``, shared with
``test_torch_shards.py``); the port's one-process results are computed in
this process while the ranks run.

The rank layouts, "R x K" for R ranks along the slab axis holding K slabs
each (a dim of the layout that names no axis holds replicas: the other
ranks run the same blocks on their own):

- (4, 2) over 8 ranks, one (slab, query column) each:
  ``distributed_neighbor_search`` on the exact, range, empty_slabs and
  faces inputs;
- a 4-slab ``ShardedSession`` on 4 x 1 (drift, reroute_range) and 2 x 2
  (drift, steady), the nearly-full 2-slab case on 2 x 1, and 1 x 4
  (drift: one rank of the layout holding every slab);
- a one-rank process group: the default mesh has no rank layout, and an
  explicit one-rank layout gives the in-process results bitwise;
- layouts whose ranks do not divide the slabs raise ``ValueError``.

On every rank: the reference's results (``assert_same_result``: counts
and indices exact but for ties, d2 within 1e-6), its resident ids (the
rank's rows), ``last_flags`` and whole ``stats()``; and the one-process
port path's results bitwise.
"""
import datetime
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _shard_cases import (assert_same_result, dist_cases, r2,
                          reference_results, session_cases, start_reference,
                          t)

WORLD = 8
SPAWN_TIMEOUT_S = 240
GLOO_TIMEOUT = datetime.timedelta(seconds=120)
DIST = ("exact", "range", "empty_slabs", "faces")
SESSIONS = {            # layout: (ranks along the slab axis, cases)
    "4x1": (4, ("drift", "reroute_range")),
    "2x2": (2, ("drift", "steady")),
    "2x1": (2, ("nearly_full",)),
    "1x4": (1, ("drift",)),
}
SESSION_CASES = [(lay, name) for lay, (_r, cases) in SESSIONS.items()
                 for name in cases]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dist_run(mesh, name, out, pre):
    """One distributed case on ``mesh``: results, and the routed point
    buffers this rank holds."""
    import repro_torch.core as tc
    from repro_torch.core import shards as ts
    from repro_torch.core.distributed import distributed_neighbor_search
    pts, qs, kw = dist_cases()[name]
    params = tc.SearchParams(**kw)
    res = distributed_neighbor_search(mesh, pts, qs, params)
    out.update({pre + "oi": res.indices, pre + "od": res.distances2,
                pre + "oc": res.counts})
    if params.mode == "knn":
        params = tc.SearchParams(**dict(kw, knn_window="exact"))
    index = tc.shard_scene(pts, params, mesh=mesh,
                           shopts=ts.STATIC_SCENE_OPTS, queries=qs,
                           query_axis="model")
    out[pre + "spts"], out[pre + "sids"] = index.pts, index.ids


def _session_run(mesh, name, out, pre):
    """One session trajectory on ``mesh``: per frame the results, this
    rank's resident ids and ``stats()`` (less the wall time)."""
    import repro_torch.core as tc
    from repro_torch.core import shards as ts
    frames, c = session_cases()[name]
    sess = tc.ShardedSession(frames[0], tc.SearchParams(**c["params"]),
                             shopts=ts.ShardOpts(**c.get("shopts", {})),
                             mesh=mesh)
    for f, frame in enumerate(frames):
        res = sess.step(frame)
        st = {k: v for k, v in sess.stats().items() if k != "t_step"}
        p = f"{pre}{f}/"
        out.update({p + "oi": res.indices, p + "od": res.distances2,
                    p + "oc": res.counts, p + "ids": sess._ids,
                    p + "stats": json.dumps(st)})


def _block(b) -> list:
    return [b.first, b.count, b.n_ranks,
            -1 if b.left is None else b.left,
            -1 if b.right is None else b.right]


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=GLOO_TIMEOUT)
    out = {}
    try:
        mesh = make_mesh_compat((4, 2), ("data", "model"), device="cpu")
        out["blocks/4x2"] = [_block(mesh.block("data")),
                             _block(mesh.block("model"))]
        for name in DIST:
            _dist_run(mesh, name, out, f"dist/{name}/")

        layouts = {lay: DeviceMesh("cpu", torch.arange(WORLD).reshape(
            WORLD // r, r), mesh_dim_names=("replica", "data"))
            for lay, (r, _cases) in SESSIONS.items()}
        for lay, name in SESSION_CASES:
            n_slabs = session_cases()[name][1]["n_slabs"]
            slabs = make_slab_mesh(n_slabs, device="cpu",
                                   ranks=layouts[lay])
            out[f"blocks/{lay}/{name}"] = _block(slabs.block("data"))
            _session_run(slabs, name, out, f"sess/{lay}/{name}/")

        errors = []
        for call in (
                lambda: make_slab_mesh(4, device="cpu"),
                lambda: make_slab_mesh(4, device="cpu", ranks=DeviceMesh(
                    "cpu", torch.arange(WORLD),
                    mesh_dim_names=("data",))),
                lambda: make_mesh_compat((4, 2), ("data", "model"),
                                         device="cpu", ranks=DeviceMesh(
                    "cpu", torch.arange(WORLD).reshape(2, 4),
                    mesh_dim_names=("data", "model")))):
            try:
                call()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = json.dumps(errors)
    finally:
        dist.destroy_process_group()

    if rank == 0:
        # a one-rank process group: no layout by default; an explicit
        # one-rank layout goes through the collectives
        dist.init_process_group("gloo", store=dist.FileStore(store + "1", 1),
                                rank=0, world_size=1, timeout=GLOO_TIMEOUT)
        try:
            out["one/auto_has_ranks"] = make_slab_mesh(
                4, device="cpu").ranks is not None
            one = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                             mesh_dim_names=("data", "model"))
            _dist_run(make_mesh_compat((4, 2), ("data", "model"),
                                       device="cpu", ranks=one),
                      "exact", out, "one/dist/exact/")
            _session_run(make_slab_mesh(4, device="cpu", ranks=one),
                         "drift", out, "one/sess/drift/")
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: _np(v) for k, v in out.items()})


def _in_process() -> dict:
    """The one-process path of every case (no process group here)."""
    from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh
    out = {}
    mesh = make_mesh_compat((4, 2), ("data", "model"), device="cpu")
    assert mesh.ranks is None
    for name in DIST:
        _dist_run(mesh, name, out, f"dist/{name}/")
    for name in dict.fromkeys(n for _lay, n in SESSION_CASES):
        n_slabs = session_cases()[name][1]["n_slabs"]
        _session_run(make_slab_mesh(n_slabs, device="cpu"), name, out,
                     f"sess/{name}/")
    return {k: _np(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 ranks' results, the reference's and the one-process path's:
    the ranks and the reference run while this process computes the
    third."""
    tmp = tmp_path_factory.mktemp("shard_ranks")
    ref_proc = start_reference(tmp)
    saved = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"          # loopback only
    try:
        ctx = mp.start_processes(_rank_main, args=(str(tmp / "store"),
                                                   str(tmp)),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("GLOO_SOCKET_IFNAME")
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = saved
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            alone = _in_process()
        finally:
            torch.set_num_threads(n)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{WORLD} gloo ranks did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s")
        ref = reference_results(ref_proc, tmp)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(ref=ref, alone=alone, ranks=ranks)


def _bitwise(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def _result(got, pre):
    from repro_torch.core import SearchResult
    return SearchResult(t(got[pre + "oi"]), t(got[pre + "od"]),
                        t(got[pre + "oc"]))


def test_rank_blocks(runs):
    """Rank r of the (4, 2) layout holds slab r // 2 and column r % 2, its
    slab-axis neighbours ranks r - 2 and r + 2; a session layout's rank
    holds its contiguous block of slabs."""
    for r, got in enumerate(runs["ranks"]):
        data, model = got["blocks/4x2"].tolist()
        s, c = divmod(r, 2)
        assert data == [s, 1, 4, r - 2 if s > 0 else -1,
                        r + 2 if s < 3 else -1]
        assert model == [c, 1, 2, r - 1 if c else -1, -1 if c else r + 1]
        for lay, name in SESSION_CASES:
            n_ranks = SESSIONS[lay][0]
            n_slabs = session_cases()[name][1]["n_slabs"]
            per, pos = n_slabs // n_ranks, r % n_ranks
            first, count, n, left, right = got[f"blocks/{lay}/{name}"]
            assert (first, count, n) == (pos * per, per, n_ranks)
            assert left == (r - 1 if pos > 0 else -1)
            assert right == (r + 1 if pos < n_ranks - 1 else -1)


@pytest.mark.parametrize("name", DIST)
def test_ranked_distributed_search(runs, name):
    """``distributed_neighbor_search`` on (4, 2) over 8 ranks: on every
    rank the whole result, bitwise the one-process path's and the
    reference's; each rank's routed rows those of its slab."""
    pts, qs, kw = dist_cases()[name]
    ref = {k.split("/", 1)[1]: v for k, v in runs["ref"].items()
           if k.startswith(name + "/")}
    alone = runs["alone"]
    pre = f"dist/{name}/"
    assert_same_result(ref["oi"], ref["od"], ref["oc"],
                       _result(alone, pre), pts, qs, r2(kw))
    for r, got in enumerate(runs["ranks"]):
        for key in ("oi", "od", "oc"):
            _bitwise(got[pre + key], alone[pre + key], (r, key))
        assert_same_result(ref["oi"], ref["od"], ref["oc"],
                           _result(got, pre), pts, qs, r2(kw))
        s = r // 2
        _bitwise(got[pre + "spts"], ref["spts"][s:s + 1], (r, "spts"))
        _bitwise(got[pre + "sids"], ref["sids"][s:s + 1], (r, "sids"))


@pytest.mark.parametrize("lay,name", SESSION_CASES,
                         ids=[f"{lay}-{name}" for lay, name in SESSION_CASES])
def test_ranked_session(runs, lay, name):
    """A ``ShardedSession`` under a rank layout, step by step on every
    rank: the whole result bitwise the one-process path's and equal to
    the reference's; the rank's resident ids the reference's rows of its
    slabs; ``last_flags`` and the whole ``stats()`` the reference's."""
    frames, c = session_cases()[name]
    ref, alone = runs["ref"], runs["alone"]
    for r, got in enumerate(runs["ranks"]):
        first, count = got[f"blocks/{lay}/{name}"][:2]
        for f, frame in enumerate(frames):
            pre, rpre = f"sess/{lay}/{name}/{f}/", f"{name}/{f}/"
            apre = f"sess/{name}/{f}/"
            for key in ("oi", "od", "oc"):
                _bitwise(got[pre + key], alone[apre + key], (r, f, key))
            _bitwise(got[pre + "ids"], alone[apre + "ids"][first:first
                                                            + count],
                     (r, f, "ids"))
            assert_same_result(ref[rpre + "oi"], ref[rpre + "od"],
                               ref[rpre + "oc"], _result(got, pre), frame,
                               frame, r2(c["params"]))
            _bitwise(got[pre + "ids"], ref[rpre + "ids"][first:first
                                                         + count],
                     (r, f, "ref ids"))
            st = json.loads(str(got[pre + "stats"]))
            assert st == json.loads(str(ref[rpre + "stats"])), (r, f)
            assert st == json.loads(str(alone[apre + "stats"])), (r, f)


def test_one_rank_group_is_the_in_process_path(runs):
    """Under a one-rank process group the default slab mesh has no rank
    layout, and an explicit one-rank layout (its gathers and reductions
    over one rank) gives the in-process results, resident ids and
    ``stats()`` bitwise."""
    got, alone = runs["ranks"][0], runs["alone"]
    assert not bool(got["one/auto_has_ranks"])
    for key in ("oi", "od", "oc", "spts", "sids"):
        _bitwise(got["one/dist/exact/" + key], alone["dist/exact/" + key],
                 key)
    frames, _c = session_cases()["drift"]
    for f in range(len(frames)):
        for key in ("oi", "od", "oc", "ids"):
            _bitwise(got[f"one/sess/drift/{f}/{key}"],
                     alone[f"sess/drift/{f}/{key}"], (f, key))
        assert str(got[f"one/sess/drift/{f}/stats"]) == \
            str(alone[f"sess/drift/{f}/stats"])


def test_rank_layout_must_divide_the_slabs(runs):
    """On 8 ranks: the default layout of 4 slabs, an explicit 8-rank
    layout of 4 slabs and a 4-rank query axis of 2 columns each raise
    ``ValueError`` on every rank."""
    for r, got in enumerate(runs["ranks"]):
        errors = json.loads(str(got["errors"]))
        assert len(errors) == 3 and all(errors), (r, errors)
