"""The LM's training step on DTensors against the unsharded step: the
counterpart of the reference's
``tests/test_multidevice.py::test_sharded_train_step_matches_single_device``
on 8 gloo CPU processes, spawned once for the file (a ``FileStore`` under
a temporary directory, loopback only), each running every case and
writing its results; each test reads its case's results. No rank imports
JAX: the reference's parameters and batches go to the ranks as numpy
arrays, and its losses are computed in this process while they run.

For each of the ten smoke configs, on a (4, 2) ``("data", "model")`` mesh
with ``OptConfig(lr=1e-3, warmup_steps=1)`` and an 8 x 16 batch with a
leading micro axis (the reference's case), the parameters placed by
``param_pspecs``, the batch over "data" and the moments by
``opt_pspecs``:

- the sharded step's loss within 1e-3 of the reference's unsharded loss
  (the reference's own bound) and within 1e-5 of the port's;
- the gradients, gathered, within 1e-5 of scale of the unsharded step's;
- the parameters after the step: within 1e-5 of scale wherever the
  unsharded gradient is at least 1e-3 of its parameter's largest. Adam's
  first step divides each gradient by its own magnitude (plus 1e-8), so
  an element whose gradient is near zero moves by up to ``lr`` on the last
  bits of that gradient, which a sharded reduction sums in another order:
  every element is held within 2 ``lr`` (the most a first step can move
  it either way, decay included);
- every optimizer moment on the placements ``opt_pspecs`` names (int8
  ``code`` and ``scale`` included, on ``lm-100m`` with quantized moments);
- a second step's loss within 1e-5 of the unsharded second step's (on
  the two MoE configs and ``lm-100m``, to keep the file's time down).

Collectives: on the ``lm-100m`` smoke step the counts by kind and the
bytes of ``hlo_analysis.count_collectives`` on the 8 real ranks equal
those under an 8-rank fake process group on the meta device (a
subprocess), and ``CommDebugMode``'s own total equals their sum; one
FSDP x TP matmul, forward and backward, makes exactly one all-gather of
the weight shard and one reduce-scatter of its gradient.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 8
SPAWN_TIMEOUT_S = 480
ARCHS = ("grok-1-314b", "lm-100m", "command-r-35b", "qwen1.5-110b",
         "qwen2-vl-7b", "minicpm3-4b", "deepseek-v3-671b",
         "recurrentgemma-2b", "whisper-tiny", "rwkv6-7b")
SECOND_STEP = ("grok-1-314b", "deepseek-v3-671b", "lm-100m")
LR = 1e-3
REF_LOSS_TOL = 1e-3
PORT_RTOL = 1e-5
WELL_CONDITIONED = 1e-3
SRC = Path(__file__).resolve().parents[1] / "src"


def _gathered(t):
    from torch.distributed.tensor import DTensor
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _placements_of(tree):
    if isinstance(tree, dict):
        return {k: _placements_of(v) for k, v in tree.items()}
    return [str(p) for p in tree.placements]


def _sharded(tree) -> bool:
    """Whether any DTensor leaf of ``tree`` is sharded on some mesh dim."""
    if isinstance(tree, dict):
        return any(_sharded(v) for v in tree.values())
    return not all(p.is_replicate() for p in tree.placements)


def _run_case(arch, arrays, mesh, quantize=False, steps=2):
    """The unsharded and the sharded step from the same parameters."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import (P, batch_pspec, make_shard_fn,
                                            opt_pspecs, param_pspecs,
                                            place_parameters, place_tree,
                                            placements)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = smoke_config(get_config(arch))
    oc = OptConfig(lr=LR, warmup_steps=1, quantize_moments=quantize)
    model = lm_params_from_arrays(cfg, arrays["params"], device="cpu")
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in arrays["batch"].items()}
    plain = copy.deepcopy(model)
    step0 = make_train_step(cfg, oc)
    opt0 = init_opt_state(plain, oc)

    named = dict(model.named_parameters())
    place_parameters(model, mesh, param_pspecs(named, mesh))
    sbatch = place_tree(batch, mesh, {
        k: P(None, *batch_pspec(mesh, v.shape[1], v.ndim - 2))
        for k, v in batch.items()})
    opt = init_opt_state(model, oc)
    step = make_train_step(cfg, oc, shard=make_shard_fn(mesh))
    out = {"losses": [], "plain_losses": []}
    for i in range(steps):
        before = {n: p.detach().clone() for n, p in plain.named_parameters()}
        _, opt0, m0 = step0(plain, opt0, batch)
        _, opt, m = step(model, opt, sbatch)
        out["plain_losses"].append(float(m0["loss"]))
        out["losses"].append(float(_gathered(m["loss"])))
        if i:
            continue
        grad_err, cond_err, any_err = 0.0, 0.0, 0.0
        for (name, p), q in zip(model.named_parameters(),
                                plain.parameters()):
            if q.grad is None:
                assert p.grad is None, name
                continue
            g = _gathered(p.grad)
            grad_err = max(grad_err, _rel_err(g, q.grad))
            got, want = _gathered(p), q.detach()
            diff = (got - want).abs()
            big = q.grad.abs() >= WELL_CONDITIONED * q.grad.abs().max()
            scale = max(1.0, float(want.abs().max()))
            cond_err = max(cond_err, float(diff[big].max()) / scale
                           if big.any() else 0.0)
            any_err = max(any_err, float(diff.max()))
            moved = float((want - before[name]).abs().max())
            assert moved <= 2 * LR * (1 + 0.1 * scale), (name, moved)

        def want(spec):
            if isinstance(spec, dict):
                return {k: want(v) for k, v in spec.items()}
            return [str(x) for x in placements(spec, mesh)]

        specs = opt_pspecs(opt, mesh)
        got_pl = {key: _placements_of(opt[key]) for key in ("m", "v")}
        out.update(grad_rel_err=grad_err, param_cond_rel_err=cond_err,
                   param_max_abs_err=any_err,
                   placements_match=got_pl == {
                       key: want(specs[key]) for key in ("m", "v")},
                   n_sharded_moments=sum(
                       _sharded(m) for m in opt["m"].values()))
    return out


def _collectives(mesh, arrays):
    """``count_collectives`` of the ``lm-100m`` smoke step on real ranks,
    and of one FSDP x TP matmul's forward and backward."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch.hlo_analysis import count_collectives
    from repro_torch.models.config import get_config
    from repro_torch.models.model import train_forward
    from repro_torch.sharding.rules import (P, batch_pspec, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree, placements)
    from repro_torch.train.train_step import replicating

    cfg = smoke_config(get_config("lm-100m"))
    model = lm_params_from_arrays(cfg, arrays["params"], device="cpu")
    model.requires_grad_(True)
    place_parameters(model, mesh, param_pspecs(
        dict(model.named_parameters()), mesh))
    batch = {k: torch.from_numpy(v[0]) for k, v in arrays["batch"].items()}
    batch = place_tree(batch, mesh, {
        k: batch_pspec(mesh, v.shape[0], v.ndim - 1)
        for k, v in batch.items()})
    shard = make_shard_fn(mesh)
    with replicating(model.parameters()):
        _, step = count_collectives(lambda: train_forward(
            model, batch, cfg, shard=shard, remat=True).backward())

    g = torch.Generator().manual_seed(0)
    x = distribute_tensor(torch.randn(64, 16, generator=g), mesh,
                          placements(P("data", None), mesh))
    w = distribute_tensor(torch.randn(16, 8, generator=g), mesh,
                          placements(P("data", "model"), mesh))
    w.requires_grad_(True)

    def matmul():
        y = x @ w
        y.backward(torch.ones_like(y))
        # the gradient leaves the backward partial over "data"; the
        # optimizer takes it to the weight's placements
        return w.grad.redistribute(w.device_mesh, w.placements)

    grad, mm = count_collectives(matmul)
    return {"step": step, "matmul": mm,
            "w_grad_placed_as_w": grad.placements == w.placements}


FAKE_COUNT = """
import json, pickle, sys, torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch.hlo_analysis import count_collectives
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.config import get_config
from repro_torch.models.model import init_params, train_forward
from repro_torch.sharding.rules import (batch_pspec, make_shard_fn,
                                        param_pspecs, place_parameters,
                                        place_tree)
from repro_torch.train.train_step import replicating
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh((4, 2), ("data", "model"))
cfg = smoke_config(get_config("lm-100m"))
model = init_params(cfg, device="meta", requires_grad=True)
place_parameters(model, mesh, param_pspecs(dict(model.named_parameters()),
                                           mesh))
batch = batch_specs(cfg, 8, 16)
batch = place_tree(batch, mesh, {k: batch_pspec(mesh, v.shape[0], v.ndim - 1)
                                 for k, v in batch.items()})
with replicating(model.parameters()):
    _, step = count_collectives(lambda: train_forward(
        model, batch, cfg, shard=make_shard_fn(mesh), remat=True).backward())
print(json.dumps(step))
"""


def _rank_main(rank: int, store_path: str, in_dir: str, out_dir: str):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    out = {}
    try:
        mesh = make_test_mesh((4, 2), ("data", "model"))
        for arch in ARCHS:
            arrays = pickle.loads(Path(in_dir, f"{arch}.pkl").read_bytes())
            t0 = time.perf_counter()
            out[arch] = _run_case(arch, arrays, mesh, steps=(
                2 if arch in SECOND_STEP else 1))
            out[arch]["seconds"] = time.perf_counter() - t0
        arrays = pickle.loads(Path(in_dir, "lm-100m.pkl").read_bytes())
        out["int8"] = _run_case("lm-100m", arrays, mesh, quantize=True,
                                steps=1)
        out["collectives"] = _collectives(mesh, arrays)
    except Exception as e:  # recorded: the tests name the failure
        import traceback
        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def _reference_case(arch: str):
    """The reference's smoke model, batch (with a leading micro axis) and
    unsharded loss, as in ``tests/test_multidevice.py:52-66``."""
    from repro.configs import smoke_config
    from repro.data.pipeline import make_batch
    from repro.models.config import get_config
    from repro.models.model import init_params

    cfg = smoke_config(get_config(arch))
    key = jax.random.PRNGKey(0)
    params = init_params(cfg, key)
    batch = make_batch(cfg, 8, 16, key)
    arrays = {"params": jax.tree.map(np.asarray, params),
              "batch": {k: np.asarray(v)[None] for k, v in batch.items()}}
    return cfg, params, batch, arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawns the 8 ranks once; computes the reference's losses and the
    fake-group count meanwhile. Returns (each rank's results, the
    reference's losses, the fake-group count)."""
    from repro.models.model import train_forward

    tmp = tmp_path_factory.mktemp("sharded_train")
    cases = {}
    for arch in ARCHS:
        cases[arch] = _reference_case(arch)
        Path(tmp, f"{arch}.pkl").write_bytes(pickle.dumps(cases[arch][3]))
    saved = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"          # loopback only
    try:
        ctx = mp.start_processes(_rank_main, args=(
            str(tmp / "store"), str(tmp), str(tmp)), nprocs=WORLD,
            join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("GLOO_SOCKET_IFNAME")
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = saved
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        ref_losses = {arch: float(jax.jit(
            lambda p, b, cfg=cfg: train_forward(p, b, cfg))(params, batch))
            for arch, (cfg, params, batch, _) in cases.items()}
        fake = subprocess.run(
            [sys.executable, "-c", FAKE_COUNT],
            env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
            text=True, timeout=240)
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{WORLD} gloo ranks did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert fake.returncode == 0, fake.stdout + fake.stderr
    results = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    for r in results:
        assert "error" not in r, r["error"]
    return results, ref_losses, json.loads(fake.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded(ranks, arch):
    results, ref_losses, _ = ranks
    for res in results:
        r = res[arch]
        assert abs(r["losses"][0] - ref_losses[arch]) < REF_LOSS_TOL
        for got, want in zip(r["losses"], r["plain_losses"]):
            assert abs(got - want) <= PORT_RTOL * max(1.0, abs(want))
        assert len(r["losses"]) == (2 if arch in SECOND_STEP else 1)
        assert r["grad_rel_err"] <= PORT_RTOL
        assert r["param_cond_rel_err"] <= PORT_RTOL
        assert r["param_max_abs_err"] <= 2 * LR
        assert r["placements_match"]
        assert r["n_sharded_moments"] > 0
    assert abs(results[0][arch]["plain_losses"][0]
               - ref_losses[arch]) < REF_LOSS_TOL


def test_int8_moments_are_placed_by_opt_pspecs(ranks):
    results, _, _ = ranks
    for res in results:
        r = res["int8"]
        assert r["placements_match"] and r["n_sharded_moments"] > 0
        assert abs(r["losses"][0] - r["plain_losses"][0]) <= PORT_RTOL * max(
            1.0, abs(r["plain_losses"][0]))
        assert r["grad_rel_err"] <= PORT_RTOL
        assert r["param_cond_rel_err"] <= PORT_RTOL


def test_collectives_on_meta_equal_real_ranks(ranks):
    results, _, fake = ranks
    for res in results:
        step = res["collectives"]["step"]
        assert step["counts"] == fake["counts"]
        assert step["per_kind_bytes"] == fake["per_kind_bytes"]
        assert step["comm_debug_total"] == sum(step["counts"].values())
        assert fake["comm_debug_total"] == sum(fake["counts"].values())
        assert step["counts"].get("all-gather", 0) > 0


def test_fsdp_tp_matmul_makes_one_gather_and_one_reduce_scatter(ranks):
    results, _, _ = ranks
    for res in results:
        mm = res["collectives"]["matmul"]
        assert mm["counts"] == {"all-gather": 1, "reduce-scatter": 1}
        # the weight's shard gathered over "data": [16, 8 / 2] float32;
        # its gradient scattered back: [16 / 4, 8 / 2]
        assert mm["per_kind_bytes"] == {"all-gather": 16 * 4 * 4,
                                        "reduce-scatter": 4 * 4 * 4}
        assert res["collectives"]["w_grad_placed_as_w"]
