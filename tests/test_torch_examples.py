"""The port's examples (``examples/*_torch.py``) against the reference's
(``examples/sph_fluid.py``, ``quickstart.py``, ``pointcloud_pipeline.py``),
on the same numpy inputs.

- SPH physics: the port's ``sph_forces`` and ``integrate`` on the
  reference's own neighbor lists (its session's, and synthetic lists with
  ``-1`` padding and self-pairs) within 1e-5 (``integrate`` 1e-6) of the
  reference's largest magnitude: XLA evaluates ``** 3`` as a product and
  may contract ``vel + DT * acc`` into an FMA, so not bitwise.
- The session trajectory: the SPH update amplifies roundoff (one ulp can
  move a neighbor across the radius), so every step starts both packages
  from the reference's positions and velocities. Per step: the same
  ``fast`` / ``replanned`` / ``respecced`` branch, counts equal, every
  returned index within the radius with its distance recomputing.
- quickstart: the stacked scenes equal single-scene calls bitwise; knn
  counts exact and ``d2`` within 1e-6 of the reference's.
- normals: covariances within 1e-5 of scale; an eigenvector's sign is
  arbitrary and a degenerate neighborhood has no unique normal, so normals
  are held up to sign, and only where the two smallest eigenvalues are
  more than 1e-3 of the largest apart.
- each example end to end with ``--device cpu`` at a small size.

Every example searches on the fused path (``SearchOpts(use_pallas=True)``),
here on the kernels' plain versions. The reference runs its own default
(``SearchOpts()``, its jnp path).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro import api as japi
from repro_torch.core.types import SearchResult

ROOT = Path(__file__).resolve().parents[1]
D2_ATOL = 1e-6
PHYS_RTOL = 1e-5
INTEGRATE_RTOL = 1e-6
NORMAL_DOT = 1 - 1e-4
EIG_GAP = 1e-3
N_SPH = 2000
SPH_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sph():
    return _load("sph_fluid"), _load("sph_fluid_torch")


def _close(got, want, rtol: float, what: str):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _ref_initial(n: int):
    """The reference example's dam-break column, as it builds it."""
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.random((n, 3), np.float32) * [0.4, 0.4, 0.8])
    return pos, jnp.zeros_like(pos)


def _forces_both(ref, port, pos, vel, idx, d2):
    acc_r, dens_r = ref.sph_forces(jnp.asarray(pos), jnp.asarray(vel),
                                   jnp.asarray(idx), jnp.asarray(d2))
    acc_p, dens_p = port.sph_forces(torch.from_numpy(np.array(pos)),
                                    torch.from_numpy(np.array(vel)),
                                    torch.from_numpy(np.array(idx)),
                                    torch.from_numpy(np.array(d2)))
    return (np.asarray(acc_r), np.asarray(dens_r), acc_p.numpy(),
            dens_p.numpy())


def _assert_in_radius(res, pos, radius: float):
    """Every returned index within the radius, its d2 recomputing."""
    idx, d2 = res.indices.numpy(), res.distances2.numpy()
    valid = idx >= 0
    np.testing.assert_array_equal(valid, np.isfinite(d2))
    assert (d2[valid] <= radius * radius + 1e-6).all()
    rec = np.sum((pos[:, None] - pos[np.clip(idx, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(rec[valid], d2[valid], atol=1e-5)


# -- SPH ------------------------------------------------------------------

def test_sph_constants_and_initial_state_match(sph):
    ref, port = sph
    for name in ("H", "K_MAX", "REST_DENSITY", "STIFFNESS", "DT"):
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(np.asarray(port.GRAVITY, np.float32),
                                  np.asarray(ref.GRAVITY))
    assert port.OPTS.use_pallas
    pos_r, vel_r = _ref_initial(N_SPH)
    pos_p, vel_p = port.initial_state(N_SPH, torch.device("cpu"))
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(vel_p.numpy(), np.asarray(vel_r))


def test_sph_forces_on_the_reference_session_lists(sph):
    ref, port = sph
    pos, _ = _ref_initial(N_SPH)
    vel = jnp.asarray(np.random.default_rng(1).normal(
        0, 0.1, (N_SPH, 3)).astype(np.float32))
    sess = jc.SimulationSession(
        pos, jc.SearchParams(radius=ref.H, k=ref.K_MAX, mode="range"),
        jc.SearchOpts())
    res = sess.step(pos)
    acc_r, dens_r, acc_p, dens_p = _forces_both(
        ref, port, pos, vel, res.indices, res.distances2)
    _close(dens_p, dens_r, PHYS_RTOL, "density")
    _close(acc_p, acc_r, PHYS_RTOL, "acceleration")
    assert float(np.mean(np.asarray(res.counts))) > 5


@pytest.mark.parametrize("n,seed", [(300, 0), (1000, 5)])
def test_sph_forces_on_synthetic_lists(sph, n, seed):
    """Random lists with -1 padding, self-pairs (d2 = 0) and pairs beyond
    H, on a column squeezed so that pressure is positive."""
    ref, port = sph
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3), np.float32) * 0.08).astype(np.float32)
    vel = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    k = ref.K_MAX
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[:, 0] = np.arange(n)                              # self-pairs
    pad = rng.random((n, k)) < 0.3
    pad[:, 0] = False
    idx[pad] = -1
    d2 = np.sum((pos[:, None] - pos[np.clip(idx, 0, None)]) ** 2,
                -1).astype(np.float32)
    d2[pad] = np.inf
    assert (d2[:, 0] == 0).all() and (d2[~pad] > ref.H ** 2).any()
    acc_r, dens_r, acc_p, dens_p = _forces_both(ref, port, pos, vel, idx, d2)
    assert float(np.max(dens_r)) > ref.REST_DENSITY
    _close(dens_p, dens_r, PHYS_RTOL, "density")
    _close(acc_p, acc_r, PHYS_RTOL, "acceleration")


def test_sph_self_pair_adds_no_force(sph):
    """A list holding only the particle itself: d2 = 0, so d = 1e-6 and
    the direction is 0; the acceleration is gravity alone, and the density
    the poly6 kernel at 0 (+1e-6), as in the reference."""
    ref, port = sph
    n = 64
    pos = np.random.default_rng(2).random((n, 3)).astype(np.float32)
    idx = np.full((n, ref.K_MAX), -1, np.int32)
    idx[:, 0] = np.arange(n)
    d2 = np.full((n, ref.K_MAX), np.inf, np.float32)
    d2[:, 0] = 0.0
    acc_r, dens_r, acc_p, dens_p = _forces_both(ref, port, pos, pos, idx, d2)
    grav = np.broadcast_to(np.asarray(port.GRAVITY, np.float32), (n, 3))
    np.testing.assert_array_equal(acc_p, grav)
    np.testing.assert_array_equal(acc_r, grav)
    _close(dens_p, dens_r, PHYS_RTOL, "density")
    assert np.all(dens_p == dens_p[0])


def test_integrate_matches_reference(sph):
    ref, port = sph
    rng = np.random.default_rng(3)
    n = 4096
    pos = rng.uniform(-0.01, 1.01, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    acc = rng.normal(0, 1e3, (n, 3)).astype(np.float32)
    pr, vr = ref.integrate(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(acc))
    pp, vp = port.integrate(torch.from_numpy(pos), torch.from_numpy(vel),
                            torch.from_numpy(acc))
    _close(pp.numpy(), pr, INTEGRATE_RTOL, "positions")
    _close(vp.numpy(), vr, INTEGRATE_RTOL, "velocities")
    walls = (np.asarray(pr) <= 0.0) | (np.asarray(pr) >= 1.0)
    assert walls.any()


def test_session_trajectory_restarted_from_reference_state(sph):
    """Five session steps at n = 2,000, each started in both packages from
    the reference's positions and velocities: the same branch, equal
    counts, in-radius lists; the port's physics on the reference's lists
    equals the reference's, and on its own lists stays finite."""
    ref, port = sph
    pos, vel = _ref_initial(N_SPH)
    jsess = jc.SimulationSession(
        pos, jc.SearchParams(radius=ref.H, k=ref.K_MAX, mode="range"),
        jc.SearchOpts())
    tsess = port.SimulationSession(torch.from_numpy(np.array(pos)),
                                   port.params(), port.OPTS, device="cpu")
    kinds = []
    for s in range(SPH_STEPS):
        pos_h, vel_h = np.array(pos), np.array(vel)
        jres = jsess.step(pos)
        tres = tsess.step(torch.from_numpy(pos_h))
        jr, tr = jsess.report, tsess.report
        for name in ("fast", "replanned", "respecced"):
            assert getattr(jr, name) == getattr(tr, name), (s, name)
        kinds.append("fast" if tr.fast else "replan")
        np.testing.assert_array_equal(tres.counts.numpy(),
                                      np.asarray(jres.counts))
        _assert_in_radius(tres, pos_h, port.H)

        acc_r, dens_r, acc_p, dens_p = _forces_both(
            ref, port, pos_h, vel_h, jres.indices, jres.distances2)
        _close(dens_p, dens_r, PHYS_RTOL, f"step {s} density")
        _close(acc_p, acc_r, PHYS_RTOL, f"step {s} acceleration")
        own = port.advance(torch.from_numpy(pos_h), torch.from_numpy(vel_h),
                           tres)
        assert all(bool(torch.isfinite(t).all()) for t in own)
        pos, vel = ref.integrate(pos, vel, jnp.asarray(acc_r))
    assert "fast" in kinds and "replan" in kinds


def test_rebuild_step_counts_match(sph, monkeypatch):
    """One ``--rebuild`` step in each package: a fresh ``NeighborSearch``
    over the frame; the lists handed to the physics have equal counts."""
    ref, port = sph
    n = 1000
    pos, vel = _ref_initial(n)
    seen = {}

    def ref_forces(pos, vel, idx, d2, _f=ref.sph_forces):
        seen["ref"] = np.asarray(idx)
        return _f(pos, vel, idx, d2)

    def port_advance(pos, vel, res, _f=port.advance):
        seen["port"] = res
        return _f(pos, vel, res)

    monkeypatch.setattr(ref, "sph_forces", ref_forces)
    monkeypatch.setattr(port, "advance", port_advance)
    out_r = ref.step_rebuild(pos, vel)
    pos_t = torch.from_numpy(np.array(pos))
    out_p = port.step_rebuild(pos_t, torch.zeros_like(pos_t))
    np.testing.assert_array_equal(seen["port"].counts.numpy(),
                                  (seen["ref"] >= 0).sum(1))
    _assert_in_radius(seen["port"], np.asarray(pos), port.H)
    assert set(out_p[3]) == set(out_r[3])
    assert out_p[4].split("=")[0] == out_r[4].split("=")[0]
    assert bool(torch.isfinite(out_p[0]).all())


# -- quickstart -------------------------------------------------------------

def test_quickstart_stacked_scenes_and_reference_counts():
    qs = _load("quickstart_torch")
    n, nq = 4000, 400
    out = qs.main(["--device", "cpu", "--points", str(n),
                   "--queries", str(nq)])
    points, queries, moved = qs.scenes(n, nq)
    params = qs.SearchParams(radius=qs.RADIUS, k=qs.K)
    # each stacked row against its single-scene call
    spec = qs.api.build_index(points, params, qs.OPTS, device="cpu").spec
    for s, p in enumerate((points, moved)):
        want = qs.api.query(qs.api.build_index(p, params, qs.OPTS, spec=spec,
                                               device="cpu"), queries)
        for f in ("indices", "distances2", "counts"):
            assert torch.equal(getattr(out["batch"], f)[s],
                               getattr(want, f)), (s, f)
    # the reference's functional query and its moved index
    jindex = japi.build_index(points, japi.SearchParams(radius=qs.RADIUS,
                                                        k=qs.K))
    jres = japi.query(jindex, queries)
    _same_knn(out["result"], jres)
    _same_knn(out["eager"], jres)
    _jindex2, jstats = japi.update_index(jindex, moved)
    assert int(out["stats"].oob) == int(jstats.oob)
    np.testing.assert_allclose(float(out["stats"].max_disp2),
                               float(jstats.max_disp2), rtol=1e-6)
    jr = jc.NeighborSearch(points, jc.SearchParams(
        radius=qs.RADIUS, k=16, mode="range"), jc.SearchOpts(bundle=True)
        ).query(queries)
    np.testing.assert_array_equal(out["range"].counts.numpy(),
                                  np.asarray(jr.counts))
    _assert_in_radius_of(out["range"], points, queries, qs.RADIUS)


def _same_knn(tres: SearchResult, jres) -> None:
    """knn: counts and inf masks exact, d2 within 1e-6, indices equal but
    between distances that tie within 1e-6."""
    rc, rd, ri = (np.asarray(jres.counts), np.asarray(jres.distances2),
                  np.asarray(jres.indices))
    gc, gd, gi = (tres.counts.numpy(), tres.distances2.numpy(),
                  tres.indices.numpy())
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(rd))
    fin = np.isfinite(gd)
    np.testing.assert_allclose(gd[fin], rd[fin], atol=D2_ATOL, rtol=0)
    for r, s in zip(*np.nonzero(gi != ri)):
        others = np.delete(gd[r], s)
        assert np.any(np.abs(others - gd[r, s]) <= D2_ATOL), (r, s)


def _assert_in_radius_of(res, points, queries, radius: float) -> None:
    idx, d2 = res.indices.numpy(), res.distances2.numpy()
    valid = idx >= 0
    assert (d2[valid] <= radius * radius + 1e-6).all()
    rec = np.sum((queries[:, None] - points[np.clip(idx, 0, None)]) ** 2, -1)
    np.testing.assert_allclose(rec[valid], d2[valid], atol=1e-5)


# -- normals ----------------------------------------------------------------

def test_normals_match_reference_up_to_sign(monkeypatch):
    ref = _load("pointcloud_pipeline")
    port = _load("pointcloud_pipeline_torch")
    assert (port.K, port.R) == (ref.K, ref.R) and port.OPTS.use_pallas
    pts = port.kitti_like_cloud(3000, seed=3)
    np.testing.assert_array_equal(pts, ref.kitti_like_cloud(3000, seed=3))
    jres = jc.NeighborSearch(pts, jc.SearchParams(radius=ref.R, k=ref.K)
                             ).query(pts)
    tres = port.NeighborSearch(pts, port.SearchParams(radius=port.R,
                                                      k=port.K),
                               port.OPTS, device="cpu").query(pts)
    _same_knn(tres, jres)

    # the reference's covariances and eigenvalues, from its own code
    seen = {}
    eigh = jnp.linalg.eigh

    def recording_eigh(cov):
        seen["cov"] = np.asarray(cov)
        w, v = eigh(cov)
        seen["w"] = np.asarray(w)
        return w, v

    monkeypatch.setattr(jnp.linalg, "eigh", recording_eigh)
    with jax.disable_jit():
        n_ref = np.asarray(ref.estimate_normals(jnp.asarray(pts),
                                                jres.indices))
    idx = torch.from_numpy(np.array(jres.indices))
    pts_t = torch.from_numpy(pts)
    cov = port.covariances(pts_t, idx).numpy()
    _close(cov, seen["cov"], PHYS_RTOL, "covariances")
    n_port = port.estimate_normals(pts_t, idx).numpy()
    w = seen["w"]
    unique = (w[:, 1] - w[:, 0]) > EIG_GAP * w[:, 2]
    dots = np.abs(np.sum(n_port * n_ref, -1))
    print(f"normals held on {int(unique.sum())} of {len(pts)} rows; "
          f"{int((~unique).sum())} excluded (no unique normal)")
    assert unique.mean() > 0.5
    assert (dots[unique] >= NORMAL_DOT).all(), float(dots[unique].min())
    np.testing.assert_allclose(np.linalg.norm(n_port, axis=-1), 1.0,
                               atol=1e-5)


# -- end to end ----------------------------------------------------------------

E2E = {
    "sph": ["sph_fluid_torch.py", "--particles", "500", "--steps", "2"],
    "sph_rebuild": ["sph_fluid_torch.py", "--particles", "500", "--steps",
                    "1", "--rebuild"],
    "quickstart": ["quickstart_torch.py", "--points", "3000", "--queries",
                   "300"],
    "pointcloud": ["pointcloud_pipeline_torch.py", "--points", "3000"],
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_example_runs_end_to_end_on_cpu(case):
    script, *args = E2E[case]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args, "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if case.startswith("sph"):
        assert proc.stdout.rstrip().endswith("ok")
    if case == "pointcloud":
        assert "sample oracle match: True" in proc.stdout
