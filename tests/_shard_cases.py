"""Inputs and reference results shared by the sharded-scene tests
(``test_torch_shards.py``, in one process; ``test_torch_shard_ranks.py``,
on gloo ranks): ``tests/test_multidevice.py``'s distributed and session
cases written with numpy, the reference's multi-slab paths run on them
in ONE subprocess under 8 forced host devices, and the comparison of a
port result with a reference result.

Nothing here imports JAX at import time: the ranks import this module.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

D2_ATOL = 1e-6
SRC = Path(__file__).resolve().parents[1] / "src"
LAYOUT_FIELDS = ("n_slabs", "n_qsplit", "lo_x", "slab_width", "halo",
                 "point_cap", "halo_cap", "migrate_cap", "query_cap")
PARAMS_KNN = dict(radius=0.1, k=8, knn_window="exact")


def layout_dict(layout) -> dict:
    d = {f: getattr(layout, f) for f in LAYOUT_FIELDS}
    s = layout.spec
    d["spec"] = [list(s.origin), s.cell_size, list(s.dims), s.capacity]
    return d


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def r2(params):
    return float(np.float32(params["radius"]) ** 2)


def assert_same_result(ri, rd, rc, res, pts, qs, r2):
    """Counts and inf masks exact, d2 within ``tol``, indices equal except
    ties within ``tol``; a row may differ only by candidates whose d2 lies
    within ``tol`` of ``r2``, and then each side equals its own brute
    force. ``tol`` is D2_ATOL times the square of the largest coordinate
    when that exceeds 1 (a frame moved out of the unit box): the expanded
    form's rounding grows with the squared norms."""
    import jax.numpy as jnp

    from repro.kernels.ref import brute_force_search as jbrute
    from repro_torch.kernels.ref import brute_force_search
    tol = D2_ATOL * max(1.0, float(np.abs(pts).max()) ** 2)
    gi, gd, gc = (res.indices.numpy(), res.distances2.numpy(),
                  res.counts.numpy())
    for r in np.nonzero(gc != rc)[0]:
        got = {int(i): d for i, d in zip(gi[r], gd[r]) if i >= 0}
        want = {int(i): d for i, d in zip(ri[r], rd[r]) if i >= 0}
        edge = [got[i] for i in got.keys() - want.keys()] + [
            want[i] for i in want.keys() - got.keys()]
        assert np.all(np.abs(np.array(edge) - r2) <= tol), (r, edge, r2)
        q = qs[r:r + 1]
        assert int(brute_force_search(t(pts), t(q), np.sqrt(r2),
                                      gi.shape[1])[2][0]) == gc[r]
        assert int(np.asarray(jbrute(jnp.asarray(pts), jnp.asarray(q),
                                     float(np.sqrt(r2)), gi.shape[1])[2])[0]) \
            == rc[r]
    same = gc == rc
    np.testing.assert_array_equal(np.isinf(rd[same]), np.isinf(gd[same]))
    fin = np.isfinite(gd) & same[:, None]
    np.testing.assert_allclose(gd[fin], rd[fin], atol=tol, rtol=0)
    for r, s in zip(*np.nonzero((gi != ri) & same[:, None])):
        others = np.delete(gd[r], s)
        assert np.any(np.abs(others - gd[r, s]) <= tol), (r, s)


def dist_cases():
    """``tests/test_multidevice.py``'s distributed inputs (:20 and the
    three edge cases of :223), knn, and the first in range mode too."""
    out = {}
    rng = np.random.default_rng(3)
    pts = rng.random((4000, 3)).astype(np.float32)
    qs = rng.random((900, 3)).astype(np.float32)
    out["exact"] = (pts, qs, dict(radius=0.07, k=8))
    out["range"] = (pts, qs, dict(radius=0.07, k=8, mode="range"))
    rng = np.random.default_rng(7)
    pts = rng.random((1500, 3)).astype(np.float32)
    pts[:, 0] = np.where(rng.random(1500) < 0.5, pts[:, 0] * 0.1,
                         0.9 + pts[:, 0] * 0.1)
    out["empty_slabs"] = (pts, rng.random((300, 3)).astype(np.float32),
                          dict(radius=0.08, k=8))
    pts = rng.random((1000, 3)).astype(np.float32)
    pts[:, 0] *= 0.05
    pts[0, 0] = 1.0
    out["skew"] = (pts, rng.random((200, 3)).astype(np.float32),
                   dict(radius=0.08, k=8))
    pts = rng.random((2000, 3)).astype(np.float32)
    qs = rng.random((256, 3)).astype(np.float32)
    lo = pts[:, 0].min()
    width = (pts[:, 0].max() - lo) / 4.0
    for i, s in enumerate([1, 2, 3] * 40):          # exact face x-coords
        qs[i, 0] = np.float32(lo + s * width)
    out["faces"] = (pts, qs, dict(radius=0.08, k=8))
    return out


def session_cases():
    """Trajectories: the 4-slab drift of ``tests/test_multidevice.py:117``,
    the y/z-only steady state of :154, the nearly-full slab of :182 (knn),
    and in range mode a hop of more than one slab, which forces a
    re-route."""
    out = {}
    knn = PARAMS_KNN
    rng = np.random.default_rng(2)
    pts = rng.random((1200, 3)).astype(np.float32)
    vel = rng.normal(0, 0.004, pts.shape).astype(np.float32)
    frames = [pts]
    for _ in range(5):
        frames.append(np.clip(frames[-1] + vel, 0.0, 1.0).astype(np.float32))
    out["drift"] = (frames, dict(params=knn, n_slabs=4))
    rng = np.random.default_rng(5)
    pts = rng.random((900, 3)).astype(np.float32)
    frames, drift = [pts, pts], np.zeros_like(pts)
    for _ in range(4):
        drift[:, 1:] = rng.normal(0, 0.0002, (900, 2))
        frames.append(np.clip(frames[-1] + drift, 0.0,
                              1.0).astype(np.float32))
    out["steady"] = (frames, dict(params=knn, n_slabs=4))
    rng = np.random.default_rng(11)
    pts = rng.random((200, 3)).astype(np.float32)
    pts[:96, 0] = pts[:96, 0] * 0.5          # slab 0: 96 rows
    pts[96:, 0] = 0.5 + pts[96:, 0] * 0.5    # slab 1: 104 rows
    moved = pts.copy()
    moved[100, 0] = 0.49
    out["nearly_full"] = (
        [pts, moved], dict(params=dict(radius=0.05, k=4, knn_window="exact"),
                           n_slabs=2, shopts=dict(point_slack=1.0,
                                                  domain_margin_radii=2.0)))
    rng = np.random.default_rng(9)
    pts = rng.random((800, 3)).astype(np.float32)
    f1 = np.clip(pts + rng.normal(0, 0.003, pts.shape), 0, 1).astype(
        np.float32)
    f2 = f1.copy()
    f2[:20, 0] = np.where(f2[:20, 0] < 0.5, f2[:20, 0] + 0.55,
                          f2[:20, 0] - 0.55)
    f3 = np.clip(f2 + rng.normal(0, 0.003, pts.shape), 0, 1).astype(
        np.float32)
    out["reroute_range"] = ([pts, f1, f2, f3], dict(
        params=dict(radius=0.1, k=8, mode="range"), n_slabs=4))
    return out


REFERENCE = r'''
import functools, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import SearchParams, ShardedSession
from repro.core.shards import (ShardOpts, STATIC_SCENE_OPTS, route_queries,
                               shard_scene)
from repro.core.distributed import distributed_neighbor_search
from repro.launch.mesh import make_mesh_compat

inp = np.load(sys.argv[1])
spec = json.loads(open(sys.argv[2]).read())
out = {}
FIELDS = %(fields)r

def layout(l):
    d = {f: getattr(l, f) for f in FIELDS}
    s = l.spec
    d["spec"] = [list(s.origin), s.cell_size, list(s.dims), s.capacity]
    return np.array(json.dumps(d))

mesh = make_mesh_compat((4, 2), ("data", "model"))
for name, kw in spec["dist"].items():
    pts, qs = inp[name + "/pts"], inp[name + "/qs"]
    params = SearchParams(**kw)
    res = distributed_neighbor_search(mesh, pts, qs, params)
    if params.mode == "knn":
        params = SearchParams(**dict(kw, knn_window="exact"))
    index = shard_scene(pts, params, mesh=mesh, shopts=STATIC_SCENE_OPTS,
                        queries=qs, query_axis="model")
    rq, qid, qovf = route_queries(index.layout, jnp.asarray(qs))
    qid_jit = jax.jit(functools.partial(route_queries, index.layout))(
        jnp.asarray(qs))[1]
    for k, v in dict(oi=res.indices, od=res.distances2, oc=res.counts,
                     spts=index.pts, sids=index.ids, rq=rq, qid=qid,
                     qovf=qovf, qid_jit=qid_jit).items():
        out[name + "/" + k] = np.asarray(v)
    out[name + "/layout"] = layout(index.layout)

for name, c in spec["sess"].items():
    frames = inp[name + "/frames"]
    sess = ShardedSession(frames[0], SearchParams(**c["params"]),
                          n_slabs=c["n_slabs"],
                          shopts=ShardOpts(**c.get("shopts", {})))
    for f, frame in enumerate(frames):
        res = sess.step(frame)
        st = {k: v for k, v in sess.stats().items() if k != "t_step"}
        pre = "%%s/%%d/" %% (name, f)
        for k, v in dict(oi=res.indices, od=res.distances2, oc=res.counts,
                         ids=sess._ids).items():
            out[pre + k] = np.asarray(v)
        out[pre + "stats"] = np.array(json.dumps(st))
        out[pre + "layout"] = layout(sess.layout)
np.savez(sys.argv[3], **out)
''' % dict(fields=LAYOUT_FIELDS)


def start_reference(tmp: Path) -> subprocess.Popen:
    """Starts the reference on every case in a subprocess under 8 forced
    host devices (the JAX device count is fixed at first use), writing
    ``tmp / "out.npz"``; :func:`reference_results` waits for it."""
    arrays, spec = {}, {"dist": {}, "sess": {}}
    for name, (pts, qs, kw) in dist_cases().items():
        arrays[name + "/pts"], arrays[name + "/qs"] = pts, qs
        spec["dist"][name] = kw
    for name, (frames, c) in session_cases().items():
        arrays[name + "/frames"] = np.stack(frames)
        spec["sess"][name] = c
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps(spec))
    (tmp / "ref.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "inputs.npz"),
         str(tmp / "spec.json"), str(tmp / "out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def reference_results(proc: subprocess.Popen, tmp: Path) -> dict:
    """The reference's results once ``proc`` has ended."""
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    return dict(np.load(tmp / "out.npz"))
