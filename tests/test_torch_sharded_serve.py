"""The LM's serving steps on DTensors against the unsharded steps and the
reference's prefill, on 8 gloo CPU processes spawned once for the file (a
``FileStore`` under a temporary directory, loopback only), each running
every case and writing its results; each test reads its case's results.
No rank imports JAX: the reference's parameters and batches go to the
ranks as numpy arrays, and its prefill logits are computed in this
process while they run.

On a (4, 2) ``("data", "model")`` mesh, for each smoke config that serves
through ``make_prefill_step`` and ``decode_step`` (every one of
``ALL_ARCHS`` but ``whisper-tiny``), the parameters placed by
``param_pspecs``, an 8 x 16 prompt by ``batch_pspec`` (``qwen2-vl-7b``
with ``pos3`` and its vision embeddings):

- the prefill's last-position logits, gathered, within 1e-5 of scale of
  the unsharded prefill's, and within ``atol=rtol=1e-4`` of the
  reference's unsharded ``make_prefill_step`` (the tolerance of
  ``test_torch_models.py`` and ``test_torch_dense_lm.py``);
- one decode token from the cache that an unsharded cache-writing prefill
  of the prompt left, placed by ``cache_pspecs``: its logits and every
  tensor of the new cache, gathered, within 1e-5 of scale of the
  unsharded step's.

``rwkv6-7b`` there: ``rwkv_scan`` runs once a layer and a step on every
rank, on local shards of B/4 rows and H/2 heads, and the returned state
carries the placements ``cache_pspecs`` gives the state. With three heads
under the model axis of 2 the heads stay whole: ``rwkv_scan`` runs on
every head, nothing comes back partial, and the results equal the
unsharded ones.

On a (2, 2, 2) ``("pod", "data", "model")`` mesh of the same ranks (the
batch split over two mesh dims, where DTensor's sharding propagation of
an einsum did not finish at production shapes): the smoke ``lm-100m`` and
``rwkv6-7b`` train step (loss within 1e-5 of the unsharded step's,
gradients within 1e-5 of scale, parameters as
``test_torch_sharded_train.py`` holds them) and prefill, the smoke
``grok-1-314b`` decode step and the smoke ``minicpm3-4b`` prefill; the
collectives of each, counted by ``hlo_analysis.count_collectives`` (kinds
and bytes), equal on the real ranks to those of the same runs under an
8-rank fake process group on the meta device (a subprocess).
"""
import copy
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 8
SPAWN_TIMEOUT_S = 480
SERVE_ARCHS = ("grok-1-314b", "lm-100m", "command-r-35b", "qwen1.5-110b",
               "qwen2-vl-7b", "minicpm3-4b", "deepseek-v3-671b",
               "recurrentgemma-2b", "rwkv6-7b")
B, S, CACHE_LEN = 8, 16, 32
WRITE = 8            # the smoke configs' local window
REF_TOL = 1e-4
PORT_RTOL = 1e-5
LR = 1e-3
WELL_CONDITIONED = 1e-3
MESH3 = ((2, 2, 2), ("pod", "data", "model"))
# (arch, kind) run on MESH3, counted on real ranks and on the meta device
THREE_AXIS = (("lm-100m", "train"), ("lm-100m", "prefill"),
              ("rwkv6-7b", "train"), ("rwkv6-7b", "prefill"),
              ("grok-1-314b", "decode"), ("minicpm3-4b", "prefill"))
SRC = Path(__file__).resolve().parents[1] / "src"


def _gathered(t):
    from torch.distributed.tensor import DTensor
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _cache_err(got, want) -> float:
    """The largest relative error over every tensor of two caches."""
    if isinstance(want, dict):
        return max((_cache_err(got[k], want[k]) for k in want), default=0.0)
    if isinstance(want, list):
        return max((_cache_err(g, w) for g, w in zip(got, want)), default=0.0)
    if isinstance(want, torch.Tensor):
        return _rel_err(_gathered(got).to(torch.float32),
                        want.to(torch.float32))
    assert got == want
    return 0.0


def _written_cache(cfg, model, tokens, pos3=None):
    """The decode cache after an unsharded cache-writing prefill of
    ``tokens`` [B, S], in pieces of :data:`WRITE` tokens (a local
    attention layer's ring buffer takes no more than its window at once),
    each at its positions."""
    from repro_torch.models import model as M

    b, s = tokens.shape
    cache = M.init_decode_cache(cfg, b, CACHE_LEN, torch.float32,
                                device="cpu")
    with torch.no_grad():
        for lo in range(0, s, WRITE):
            hi = min(s, lo + WRITE)
            pos = None
            if cfg.pos == "mrope":
                pos = pos3[:, lo:hi]
            elif cfg.pos == "rope":
                pos = M.positions(cfg, b, hi - lo, tokens.device, offset=lo)
            _, cache = M.decode_step(model, cache, tokens[:, lo:hi], cfg,
                                     pos=pos)
    return cache


def _token_pos(cfg, b, length):
    """The position of one decode token after ``length`` cached ones."""
    if cfg.pos == "mrope":
        return torch.full((b, 1, 3), length, dtype=torch.int32)
    return None


def _serve_batch(batch):
    return {k: batch[k] for k in ("tokens", "pos3", "vision_embeds")
            if k in batch}


def _place_batch(batch, mesh):
    from repro_torch.sharding.rules import batch_pspec, place_tree
    return place_tree(batch, mesh, {k: batch_pspec(mesh, v.shape[0],
                                                   v.ndim - 1)
                                    for k, v in batch.items()})


def _serve_case(cfg, model, batch, mesh, calls=None):
    """The unsharded prefill and one decode token on ``model`` (plain),
    then the same on a copy placed on ``mesh``: the gathered results'
    errors against the unsharded ones, and the unsharded prefill logits.
    ``calls`` collects the ``rwkv_scan`` calls of the sharded steps."""
    from repro_torch.sharding.rules import (cache_pspecs, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree, placements)
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    batch = _serve_batch(batch)
    logits0 = make_prefill_step(cfg)(model, batch)
    cache = _written_cache(cfg, model, batch["tokens"], batch.get("pos3"))
    decode0 = make_decode_step(cfg)
    tok = (batch["tokens"][:, -1:] + 1) % cfg.vocab
    pos = _token_pos(cfg, B, S)
    dlog0, dcache0 = decode0(model, cache, tok, pos)

    sharded = copy.deepcopy(model)
    place_parameters(sharded, mesh, param_pspecs(
        dict(sharded.named_parameters()), mesh))
    shard = make_shard_fn(mesh)
    specs = cache_pspecs(cache, mesh, B)
    scache = place_tree(cache, mesh, specs)
    if calls is not None:
        calls.clear()
    logits = make_prefill_step(cfg, shard=shard)(
        sharded, _place_batch(batch, mesh))
    prefill_calls = list(calls) if calls is not None else []
    dlog, dcache = make_decode_step(cfg, shard=shard)(
        sharded, scache, _place_batch({"tokens": tok}, mesh)["tokens"], pos)
    out = {"prefill_rel_err": _rel_err(_gathered(logits), logits0),
           "decode_rel_err": _rel_err(_gathered(dlog), dlog0),
           "cache_rel_err": _cache_err(dcache, dcache0),
           "logits": logits0.tolist()}
    if calls is not None:
        out["prefill_calls"] = prefill_calls
        out["decode_calls"] = calls[len(prefill_calls):]
        out["state_placements"] = [
            [repr(p) for p in c["tm"]["state"].placements] for c in dcache]
        out["state_spec_placements"] = [
            [repr(p) for p in placements(sp["tm"]["state"], mesh)]
            for sp in specs]
    return out


def _recording(calls):
    """``rwkv_scan`` wrapped so that each call records whether it was
    handed DTensors, its (local) shapes and, for DTensor results, their
    placements. Patched in where ``layers`` and the wrapper itself call
    it: a DTensor call shows as one record with ``dtensor`` true followed
    by the local call it makes."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.models import layers as L

    orig = scan.rwkv_scan

    def rec(r, k, v, w, u, state0):
        out, state = orig(r, k, v, w, u, state0)
        entry = {"dtensor": isinstance(r, DTensor),
                 "r": list(r.shape), "state0": list(state0.shape)}
        if isinstance(out, DTensor):
            entry["out_placements"] = [repr(p) for p in out.placements]
            entry["state_placements"] = [repr(p) for p in state.placements]
            entry["local_r"] = list(r.to_local().shape)
        calls.append(entry)
        return out, state

    scan.rwkv_scan = rec
    L.rwkv_scan = rec


def _heads_not_divided(mesh, calls):
    """The smoke ``rwkv6-7b`` cut to three heads (d_model 48), prefill and
    a decode token on (4, 2): the model axis of 2 divides no head count,
    so the heads stay whole on every rank."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config

    cfg = dataclasses.replace(smoke_config(get_config("rwkv6-7b")),
                              d_model=48)
    model = M.init_params(cfg, 3, device="cpu")
    batch = make_batch(cfg, B, S, torch.Generator().manual_seed(3),
                       device="cpu")
    return _serve_case(cfg, model, batch, mesh, calls)


def _train_case(cfg, model, batch, mesh, count):
    """The unsharded train step and the step on ``mesh`` from the same
    parameters (``OptConfig(lr=1e-3, warmup_steps=1)``, the batch with a
    leading micro axis): the loss, gradient and parameter errors, and the
    sharded step's collectives."""
    from repro_torch.sharding.rules import (P, batch_pspec, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    oc = OptConfig(lr=LR, warmup_steps=1)
    model.requires_grad_(True)
    micro = {k: v[None] for k, v in batch.items()}
    plain = copy.deepcopy(model)
    _, _, m0 = make_train_step(cfg, oc)(plain, init_opt_state(plain, oc),
                                        micro)
    place_parameters(model, mesh, param_pspecs(
        dict(model.named_parameters()), mesh))
    smicro = place_tree(micro, mesh, {
        k: P(None, *batch_pspec(mesh, v.shape[1], v.ndim - 2))
        for k, v in micro.items()})
    opt = init_opt_state(model, oc)
    step = make_train_step(cfg, oc, shard=make_shard_fn(mesh))
    (_, _, m), coll = count(lambda: step(model, opt, smicro))
    grad_err, cond_err, any_err = 0.0, 0.0, 0.0
    for p, q in zip(model.parameters(), plain.parameters()):
        if q.grad is None:
            assert p.grad is None
            continue
        grad_err = max(grad_err, _rel_err(_gathered(p.grad), q.grad))
        diff = (_gathered(p) - q.detach()).abs()
        big = q.grad.abs() >= WELL_CONDITIONED * q.grad.abs().max()
        scale = max(1.0, float(q.detach().abs().max()))
        cond_err = max(cond_err, float(diff[big].max()) / scale
                       if big.any() else 0.0)
        any_err = max(any_err, float(diff.max()))
    return {"loss": float(_gathered(m["loss"])),
            "plain_loss": float(m0["loss"]), "grad_rel_err": grad_err,
            "param_cond_rel_err": cond_err, "param_max_abs_err": any_err,
            "collectives": coll}


def three_axis_counts(device: str, arrays_of=None, mesh=None) -> dict:
    """Each :data:`THREE_AXIS` run on ``mesh`` (default: the (2, 2, 2)
    test mesh), counted by ``count_collectives``. On ``"meta"`` the
    parameters come from ``init_params`` and the batch from
    ``batch_specs``, and only the counts are returned; on ``"cpu"``
    ``arrays_of(arch)`` gives the reference's arrays and each run is also
    held against its unsharded counterpart."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.data.pipeline import batch_specs
    from repro_torch.launch.hlo_analysis import count_collectives
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import (cache_pspecs, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree)
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    mesh = mesh if mesh is not None else make_test_mesh(*MESH3)
    shard = make_shard_fn(mesh)
    out = {}
    for arch, kind in THREE_AXIS:
        cfg = smoke_config(get_config(arch))
        if device == "meta":
            model = M.init_params(cfg, device="meta")
            batch = batch_specs(cfg, B, S)
        else:
            arrays = arrays_of(arch)
            model = lm_params_from_arrays(cfg, arrays["params"],
                                          device="cpu")
            batch = {k: torch.from_numpy(v)
                     for k, v in arrays["batch"].items()}
        key = f"{arch} {kind}"
        if kind == "train":
            if device == "meta":
                from repro_torch.sharding.rules import P, batch_pspec
                from repro_torch.train.optimizer import (OptConfig,
                                                         init_opt_state)
                from repro_torch.train.train_step import make_train_step
                oc = OptConfig(lr=LR, warmup_steps=1)
                model.requires_grad_(True)
                place_parameters(model, mesh, param_pspecs(
                    dict(model.named_parameters()), mesh))
                micro = place_tree({k: v[None] for k, v in batch.items()},
                                   mesh, {k: P(None, *batch_pspec(
                                       mesh, v.shape[0], v.ndim - 1))
                                       for k, v in batch.items()})
                opt = init_opt_state(model, oc)
                step = make_train_step(cfg, oc, shard=shard)
                out[key] = {"collectives": count_collectives(
                    lambda: step(model, opt, micro))[1]}
            else:
                out[key] = _train_case(cfg, model, batch, mesh,
                                       count_collectives)
            continue
        plain = None if device == "meta" else copy.deepcopy(model)
        place_parameters(model, mesh, param_pspecs(
            dict(model.named_parameters()), mesh))
        sbatch = _serve_batch(batch)
        if kind == "prefill":
            logits, coll = count_collectives(lambda: make_prefill_step(
                cfg, shard=shard)(model, _place_batch(sbatch, mesh)))
            rec = {"collectives": coll}
            if plain is not None:
                rec["rel_err"] = _rel_err(_gathered(logits),
                                          make_prefill_step(cfg)(plain,
                                                                 sbatch))
        else:
            tokens = batch["tokens"]
            if plain is not None:
                cache = _written_cache(cfg, plain, tokens)
            else:
                cache = M.init_decode_cache(cfg, B, CACHE_LEN, torch.float32,
                                            device=device)
                for layer in cache:
                    if "length" in layer:
                        layer["length"] = S
            tok = tokens[:, -1:]
            scache = place_tree(cache, mesh, cache_pspecs(cache, mesh, B))
            (logits, _), coll = count_collectives(lambda: make_decode_step(
                cfg, shard=shard)(model, scache,
                                  _place_batch({"tokens": tok},
                                               mesh)["tokens"]))
            rec = {"collectives": coll}
            if plain is not None:
                want, _ = make_decode_step(cfg)(plain, cache, tok)
                rec["rel_err"] = _rel_err(_gathered(logits), want)
        out[key] = rec
    return out


FAKE_COUNT = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
sys.path.insert(0, {tests!r})
import test_torch_sharded_serve as T
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
print(json.dumps(T.three_axis_counts("meta")))
"""


def _rank_main(rank: int, store_path: str, in_dir: str, out_dir: str):
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import get_config

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    out = {}

    def arrays_of(arch):
        return pickle.loads(Path(in_dir, f"{arch}.pkl").read_bytes())

    try:
        mesh = make_test_mesh((4, 2), ("data", "model"))
        calls: list = []
        _recording(calls)
        for arch in SERVE_ARCHS:
            cfg = smoke_config(get_config(arch))
            arrays = arrays_of(arch)
            model = lm_params_from_arrays(cfg, arrays["params"],
                                          device="cpu")
            batch = {k: torch.from_numpy(v)
                     for k, v in arrays["batch"].items()}
            t0 = time.perf_counter()
            out[arch] = _serve_case(cfg, model, batch, mesh,
                                    calls if arch == "rwkv6-7b" else None)
            out[arch]["seconds"] = time.perf_counter() - t0
        out["heads_not_divided"] = _heads_not_divided(mesh, calls)
        t0 = time.perf_counter()
        out["three_axis"] = three_axis_counts("cpu", arrays_of)
        out["three_axis_seconds"] = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({a: out[a]["seconds"] for a in SERVE_ARCHS}
                             | {"3": out["three_axis_seconds"]}),
                  file=sys.stderr)
    except Exception as e:  # recorded: the tests name the failure
        import traceback
        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def _reference_case(arch: str):
    """The reference's smoke model and 8 x 16 batch (as
    ``tests/test_multidevice.py:52-66`` makes them) as numpy arrays, and
    its unsharded prefill's logits."""
    import jax

    from repro.configs import smoke_config
    from repro.data.pipeline import make_batch
    from repro.models.config import get_config
    from repro.models.model import init_params
    from repro.train.serve_step import make_prefill_step

    cfg = smoke_config(get_config(arch))
    key = jax.random.PRNGKey(0)
    params = init_params(cfg, key)
    batch = make_batch(cfg, B, S, key)
    arrays = {"params": jax.tree.map(np.asarray, params),
              "batch": {k: np.asarray(v) for k, v in batch.items()}}
    serve = {k: v for k, v in batch.items()
             if k in ("tokens", "pos3", "vision_embeds")}
    return arrays, lambda: np.asarray(
        jax.jit(make_prefill_step(cfg))(params, serve))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawns the 8 ranks once; computes the reference's prefill logits
    and the fake-group counts meanwhile. Returns (each rank's results,
    the reference's logits by arch, the fake-group counts)."""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    prefill = {}
    for arch in SERVE_ARCHS:
        arrays, prefill[arch] = _reference_case(arch)
        Path(tmp, f"{arch}.pkl").write_bytes(pickle.dumps(arrays))
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
        ref_logits = {arch: fn() for arch, fn in prefill.items()}
        fake = subprocess.run(
            [sys.executable, "-c", FAKE_COUNT.format(
                tests=str(Path(__file__).resolve().parent))],
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
    return results, ref_logits, json.loads(fake.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_unsharded_and_reference(ranks, arch):
    results, ref_logits, _ = ranks
    for res in results:
        r = res[arch]
        assert r["prefill_rel_err"] <= PORT_RTOL
        assert r["decode_rel_err"] <= PORT_RTOL
        assert r["cache_rel_err"] <= PORT_RTOL
    np.testing.assert_allclose(np.asarray(results[0][arch]["logits"]),
                               ref_logits[arch], atol=REF_TOL, rtol=REF_TOL)


def test_rwkv_scan_runs_per_rank_on_its_shard(ranks):
    """Once a layer and a step, each on B/4 rows and H/2 heads; the
    state returned on the cache spec's placements."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.config import get_config

    cfg = smoke_config(get_config("rwkv6-7b"))
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    results, _, _ = ranks
    for res in results:
        r = res["rwkv6-7b"]
        for calls, s in ((r["prefill_calls"], S), (r["decode_calls"], 1)):
            outer = [c for c in calls if c["dtensor"]]
            local = [c for c in calls if not c["dtensor"]]
            assert len(outer) == len(local) == cfg.n_layers
            assert all(c["local_r"] == [B // 4, s, h // 2, hd]
                       and c["r"] == [B, s, h, hd] for c in outer)
            assert all(c["r"] == [B // 4, s, h // 2, hd]
                       and c["state0"] == [B // 4, h // 2, hd, hd]
                       for c in local)
            for c in outer:
                assert c["out_placements"] == ["Shard(dim=0)",
                                               "Shard(dim=2)"], c
                assert c["state_placements"] == ["Shard(dim=0)",
                                                 "Shard(dim=1)"], c
        assert r["state_placements"] == r["state_spec_placements"] == [
            ["Shard(dim=0)", "Shard(dim=1)"]] * cfg.n_layers


def test_heads_the_model_axis_does_not_divide_stay_whole(ranks):
    results, _, _ = ranks
    for res in results:
        r = res["heads_not_divided"]
        assert r["prefill_rel_err"] <= PORT_RTOL
        assert r["decode_rel_err"] <= PORT_RTOL
        assert r["cache_rel_err"] <= PORT_RTOL
        outer = [c for c in r["prefill_calls"] + r["decode_calls"]
                 if c["dtensor"]]
        assert outer
        for c in outer:
            assert c["local_r"][2] == c["r"][2] == 3
            assert c["out_placements"] == ["Shard(dim=0)", "Replicate()"]
            assert c["state_placements"] == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("case", [f"{a} {k}" for a, k in THREE_AXIS])
def test_three_axis_mesh_matches_unsharded_and_meta_counts(ranks, case):
    results, _, fake = ranks
    for res in results:
        r = res["three_axis"][case]
        if case.endswith("train"):
            assert abs(r["loss"] - r["plain_loss"]) <= PORT_RTOL * max(
                1.0, abs(r["plain_loss"]))
            assert r["grad_rel_err"] <= PORT_RTOL
            assert r["param_cond_rel_err"] <= PORT_RTOL
            assert r["param_max_abs_err"] <= 2 * LR
        else:
            assert r["rel_err"] <= PORT_RTOL
        coll, want = r["collectives"], fake[case]["collectives"]
        assert coll["counts"] == want["counts"]
        assert coll["per_kind_bytes"] == want["per_kind_bytes"]
        assert coll["comm_debug_total"] == sum(coll["counts"].values())
        assert sum(coll["counts"].values()) > 0
