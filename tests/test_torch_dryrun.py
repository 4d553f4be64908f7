"""The port's dry run (``repro_torch.launch.dryrun``, ``hlo_analysis``)
against the JAX reference's arithmetic, its meshes, and its CLI.

- ``applicable``, ``microbatching``, ``_profile_for`` (the reference's
  13e9 threshold passed in), ``model_flops_global`` and
  ``analytic_activation_bytes`` equal the reference's for every arch x
  shape x mesh (the dry run's (16, 16) and (2, 16, 16); the activation
  model on (4, 2) and (8,) too); ``sharded_bytes`` and the static bytes
  per device of every cell (``build_cell``) equal the
  reference's own functions composed on per-layer shapes (its trees from
  ``jax.eval_shape`` at bfloat16, unstacked by name), less the 4 bytes of
  each of its int32 cache ``length`` leaves (the port's is a host int);
- FLOPs and bytes accessed counted on the meta device equal those counted
  on real CPU tensors of the same smoke train step (``FlopCounterMode``,
  ``OpBytes``), and the prefill's;
- the roofline's dominant term without collectives, ``memory_summary``;
- ``make_production_mesh`` raises without enough ranks; in a subprocess
  with a 512-rank fake group it builds (16, 16), (2, 16, 16) and a test
  mesh;
- the CLI end to end in a subprocess: ``whisper-tiny`` on the pod mesh,
  its train cell ``ok`` and three cells ``skipped``, its JSONs and exit
  code.

The reference's ``count_params`` (an ``eval_shape`` of its init, about a
second at full size) is memoised by monkeypatching. Its ``dryrun`` module
sets ``XLA_FLAGS`` when imported; the test restores the variable, after
JAX's backend is up.
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.hlo_analysis as JH
import repro.models.model as JM
import repro.sharding.rules as JR
from repro.configs import applicable as j_applicable
from repro.models.config import get_config as j_get
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable, smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun as TD
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models.config import get_config

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 4, "model": 2},
          "data8": {"data": 8}}
REF_BUDGET = 13e9


def _import_ref_dryrun():
    jax.devices()                       # the backend is up: flags are read
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return JD


JD = _import_ref_dryrun()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REF_COUNT = functools.cache(JM.count_params)


@pytest.fixture(autouse=True)
def _memo_ref_count(monkeypatch):
    monkeypatch.setattr(JM, "count_params", _REF_COUNT)
    monkeypatch.setattr(JD, "count_params", _REF_COUNT)


def _stand_in(axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def _view(s):
    return np.broadcast_to(np.zeros((), s.dtype), s.shape)


def _nest(by_name: dict) -> dict:
    out: dict = {}
    for name, leaf in by_name.items():
        node = out
        *parents, last = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


@functools.cache
def _ref_params(arch):
    return jax.eval_shape(
        lambda k: JM.init_params(j_get(arch), k, jnp.bfloat16),
        jax.random.PRNGKey(0))


def _per_layer(arch, tree) -> dict:
    """A reference tree as a per-layer tree of zero-stride views, by the
    port's names."""
    return _nest(convert.lm_arrays_by_name(get_config(arch),
                                           jax.tree.map(_view, tree)))


@functools.cache
def _ref_layer_params(arch):
    return _per_layer(arch, _ref_params(arch))


@functools.cache
def _ref_layer_opt(arch, quant):
    """The reference's optimizer state (``eval_shape`` of its stacked
    tree's, which unstacks to the per-layer one) per layer."""
    opt = jax.eval_shape(lambda p: JO.init_opt_state(
        p, JO.OptConfig(quantize_moments=quant)), _ref_params(arch))
    return {"step": opt["step"], "m": _per_layer(arch, opt["m"]),
            "v": _per_layer(arch, opt["v"])}


def _ref_layer_cache(arch, b, s):
    cache = jax.eval_shape(
        lambda: JM.init_decode_cache(j_get(arch), b, s, jnp.bfloat16))
    return convert._unstack(jax.tree.map(_view, cache), get_config(arch))


def _ref_cell(arch, shape, axes):
    """The reference's dry-run arithmetic (its ``build_cell`` without the
    compile) on per-layer trees: (meta, static bytes of its int32 cache
    lengths)."""
    j_cfg, mesh = j_get(arch), _stand_in(axes)
    params = _ref_layer_params(arch)
    cache_bytes = lengths = 0
    if shape.kind == "decode":
        cache = _ref_layer_cache(arch, shape.global_batch, shape.seq_len)
        c_specs = JR.cache_pspecs(cache, mesh, shape.global_batch)
        cache_bytes = JH.sharded_bytes(cache, c_specs, mesh)
        lengths = 4 * sum(1 for layer in cache if "length" in layer)
    profile = JD._profile_for(params, shape, mesh, cache_bytes)
    static = JH.sharded_bytes(params, JR.param_pspecs(params, mesh, profile),
                              mesh)
    meta = {}
    if shape.kind == "train":
        n_micro, b_micro = JD.microbatching(j_cfg, shape, mesh)
        quant = JM.count_params(j_cfg) > 3e10
        opt = _ref_layer_opt(arch, quant)
        static += JH.sharded_bytes(opt, JR.opt_pspecs(opt, mesh), mesh)
        meta = {"n_micro": n_micro, "b_micro": b_micro,
                "quantized_opt": quant}
    elif shape.kind == "decode":
        static += cache_bytes
        meta = {"cache_len": shape.seq_len}
    meta["param_profile"] = profile
    meta["static_bytes_per_device"] = int(static)
    meta["analytic_peak_bytes"] = int(
        static + JH.analytic_activation_bytes(j_cfg, shape, mesh, meta))
    return meta, lengths


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_arithmetic_matches_reference(arch):
    cfg, j_cfg = get_config(arch), j_get(arch)
    for shape_name, shape in SHAPES.items():
        ok = applicable(cfg, shape)
        assert ok == j_applicable(j_cfg, shape)
        assert TD.model_flops_global(cfg, shape) == \
            JD.model_flops_global(j_cfg, shape)
        if not ok[0]:
            continue
        for mesh_name in ("pod", "multipod"):
            axes = MESHES[mesh_name]
            want, lengths = _ref_cell(arch, shape, axes)
            _, got = TD.build_cell(cfg, shape, axes, budget=REF_BUDGET)
            key = (arch, shape_name, mesh_name)
            assert got["param_profile"] == want["param_profile"], key
            assert got["static_bytes_per_device"] == \
                want["static_bytes_per_device"] - lengths, key
            assert got["analytic_peak_bytes"] == \
                want["analytic_peak_bytes"] - lengths, key
            assert {k: v for k, v in got.items() if k not in (
                "static_bytes_per_device", "analytic_peak_bytes")} == {
                k: v for k, v in want.items() if k not in (
                    "static_bytes_per_device", "analytic_peak_bytes")}, key
            if shape.kind == "train":
                assert TD.microbatching(cfg, shape, axes) == \
                    JD.microbatching(j_cfg, shape, _stand_in(axes))


def test_analytic_activation_bytes_match_reference():
    """Every arch x shape x mesh, train cells at several microbatches; a
    float32 residual (``resid_bytes=4``) doubles only the residual
    terms."""
    for arch in ALL_ARCHS:
        cfg, j_cfg = get_config(arch), j_get(arch)
        for shape in SHAPES.values():
            for axes in MESHES.values():
                for meta in ({}, {"b_micro": 16}, {"b_micro": 256}):
                    want = JH.analytic_activation_bytes(
                        j_cfg, shape, _stand_in(axes), meta)
                    assert TH.analytic_activation_bytes(
                        cfg, shape, axes, meta) == want
                    f32 = TH.analytic_activation_bytes(
                        cfg, shape, axes, meta, resid_bytes=4)
                    assert f32 > want


def test_sharded_bytes_matches_reference_and_skips_host_ints():
    rng = np.random.default_rng(0)
    axes = MESHES["small"]
    tree = {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": [rng.standard_normal((4, 3, 5)).astype(np.float32),
                  np.zeros((7,), np.int8)]}
    specs = {"a": JR.P("data", "model"),
             "b": [JR.P(None, None, None), JR.P()]}
    want = JH.sharded_bytes(tree, specs, _stand_in(axes))
    t_tree = {"a": torch.from_numpy(tree["a"]),
              "b": [torch.from_numpy(tree["b"][0]),
                    torch.from_numpy(tree["b"][1])], "length": 5}
    t_specs = {"a": ("data", "model"), "b": [(None, None, None), ()],
               "length": None}
    assert TH.sharded_bytes(t_tree, t_specs, axes) == want == \
        8 * 6 * 4 // 8 + 4 * 3 * 5 * 4 + 7


def test_roofline_without_collectives_and_memory_summary():
    terms = TH.roofline({"flops": 989e12, "bytes accessed": 6.7e12}, None,
                        chips=4, model_flops_global=4 * 500e12)
    d = terms.to_dict()
    assert d["collective_s"] is None and d["dominant"] == "memory"
    assert d["compute_s"] == pytest.approx(1.0)
    assert d["memory_s"] == pytest.approx(2.0)
    assert d["useful_flops_ratio"] == pytest.approx(500 / 989)
    assert TH.roofline({"flops": 1e15}, {"total_bytes": 1e12}, chips=1,
                       model_flops_global=0.0).dominant == "collective"
    assert TH.memory_summary({"static_bytes_per_device": 3,
                              "analytic_peak_bytes": 5}) == {
        "source": "analytic", "static_bytes_per_device": 3,
        "analytic_peak_bytes": 5}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "lm-100m", "grok-1-314b",
                                  "whisper-tiny"])
def test_meta_counts_equal_real_cpu_counts(arch):
    """``count_step`` on the meta device against ``FlopCounterMode`` and
    ``OpBytes`` over the same smoke train step (and the prefill, where the
    model is served by it) on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = smoke_config(get_config(arch))
    axes = MESHES["small"]
    shape = ShapeSpec("smoke_train", 16, 8, "train")
    objs, meta = TD.build_cell(cfg, shape, axes)
    flops, op_bytes = TD.count_step(cfg, shape, objs)
    assert flops > 0 and op_bytes > 0

    model = TM.init_params(cfg, dtype=TD.PARAM_DTYPE, device="cpu",
                           requires_grad=True)
    batch = make_batch(cfg, meta["b_micro"], shape.seq_len,
                       torch.Generator().manual_seed(0), TD.PARAM_DTYPE,
                       device="cpu")
    fc, ob = FlopCounterMode(display=False), TH.OpBytes()
    with fc, ob:
        TM.train_forward(model, batch, cfg, remat=True).backward()
    assert fc.get_total_flops() == flops
    assert ob.bytes == op_bytes

    if cfg.enc_dec or cfg.layer_pattern == ("rwkv",):
        return          # served by its pieces / rwkv_scan not counted
    shape = ShapeSpec("smoke_prefill", 16, 2, "prefill")
    objs, _ = TD.build_cell(cfg, shape, axes)
    flops, op_bytes = TD.count_step(cfg, shape, objs)
    model.requires_grad_(False)
    fc, ob = FlopCounterMode(display=False), TH.OpBytes()
    with fc, ob:
        from repro_torch.train.serve_step import make_prefill_step
        make_prefill_step(cfg)(model, {k: v[:2] for k, v in batch.items()
                                       if k in objs["batch"]})
    assert (fc.get_total_flops(), ob.bytes) == (flops, op_bytes)


def test_opt_state_specs_are_meta_and_match_init_opt_state():
    """The meta state has ``init_opt_state``'s names, shapes and dtypes
    (a CPU smoke model's, plain and int8)."""
    from repro_torch.train import init_opt_state, opt_state_specs
    from repro_torch.train.optimizer import OptConfig
    cfg = smoke_config(get_config("deepseek-v3-671b"))
    model = TM.init_params(cfg, device="cpu")
    for quant in (False, True):
        ocfg = OptConfig(quantize_moments=quant)
        real, meta = init_opt_state(model, ocfg), opt_state_specs(model, ocfg)
        flat_r = jax.tree_util.tree_leaves_with_path(real)
        flat_m = jax.tree_util.tree_leaves_with_path(meta)
        assert [p for p, _ in flat_r] == [p for p, _ in flat_m]
        for (_, r), (_, m) in zip(flat_r, flat_m):
            assert m.is_meta and (m.shape, m.dtype) == (r.shape, r.dtype)


def test_production_mesh_needs_ranks():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True)


def _run(code_or_args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *code_or_args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_meshes_in_a_fake_group():
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh, "
        "make_test_mesh\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, "
        "world_size=512)\n"
        "for m in (make_production_mesh(), "
        "make_production_mesh(multi_pod=True), make_test_mesh()):\n"
        "    print(tuple(m.shape), m.mesh_dim_names, m.device_type)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "(16, 16) ('data', 'model') cpu",
        "(2, 16, 16) ('pod', 'data', 'model') cpu",
        "(2, 2) ('data', 'model') cpu"]


def test_cli_one_arch_on_the_pod_mesh(tmp_path):
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
                 "--mesh", "pod", "--out-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry-run cells: 1 ok, 3 skipped (documented), 0 errors" in \
        proc.stdout
    cells = {p.name: json.loads(p.read_text())
             for p in tmp_path.glob("*.json")}
    assert set(cells) == {f"pod__whisper-tiny__{s}.json" for s in SHAPES}
    cell = cells["pod__whisper-tiny__train_4k.json"]
    assert cell["status"] == "ok" and cell["chips"] == 256
    coll = cell["collectives"]
    assert cell["collectives_reason"] is None
    assert set(coll["counts"]) <= {"all-gather", "reduce-scatter",
                                   "all-reduce", "all-to-all", "broadcast"}
    assert coll["counts"]["all-gather"] > 0
    assert coll["comm_debug_total"] == sum(coll["counts"].values())
    assert coll["total_bytes"] == sum(coll["per_kind_bytes"].values()) > 0
    assert coll["composed_from_periods"] == [1, 2]
    terms = cell["roofline"]
    assert terms["collective_bytes_per_device"] == coll["total_bytes"]
    assert terms["collective_s"] == pytest.approx(
        coll["total_bytes"] / TH.LINK_BW)
    assert terms["dominant"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: terms[f"{k}_s"])
    assert cell["param_bytes_rank0_dtensor"] > 0
    cfg = get_config("whisper-tiny")
    want = TD.build_cell(cfg, SHAPES["train_4k"], MESHES["pod"])[1]
    assert cell["meta"] == want
    assert cell["param_count"] == TM.count_params(cfg)
    assert cells["pod__whisper-tiny__decode_32k.json"]["status"] == "skipped"


@pytest.mark.parametrize("arch, shape, mesh", [
    ("rwkv6-7b", "decode_32k", "pod"), ("lm-100m", "prefill_32k", "multipod")])
def test_cli_counts_collectives_of_a_serving_cell(tmp_path, arch, shape,
                                                   mesh):
    """A serving cell that ``rwkv_scan`` once kept off DTensors, and one
    on the two-pod mesh (its batch sharded over "pod" and "data"): both
    counted."""
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", mesh, "--out-dir",
                 str(tmp_path)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry-run cells: 1 ok, 0 skipped (documented), 0 errors" in \
        proc.stdout
    cell = json.loads((tmp_path / f"{mesh}__{arch}__{shape}.json")
                      .read_text())
    assert cell["status"] == "ok"
    assert cell["chips"] == TD.MESH_WORLD[mesh]
    assert cell["collectives_reason"] is None
    coll = cell["collectives"]
    assert coll["counts"] and all(v > 0 for v in coll["counts"].values())
    assert coll["comm_debug_total"] == sum(coll["counts"].values())
    assert coll["total_bytes"] == sum(coll["per_kind_bytes"].values()) > 0
    assert cell["roofline"]["collective_bytes_per_device"] == \
        coll["total_bytes"]


RWKV_SCAN_META = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.kernels import rwkv_scan as scan
from repro_torch.launch.mesh import make_test_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
b, s, h, hd = 8, 5, 4, 16
out = {}
for shape, names, pl in (((4, 2), ("data", "model"), [Shard(0), Shard(2)]),
                         ((2, 2, 2), ("pod", "data", "model"),
                          [Shard(0), Shard(0), Shard(2)])):
    mesh = make_test_mesh(shape, names)
    seq = [distribute_tensor(torch.empty(b, s, h, hd, device="meta"), mesh, pl,
                             src_data_rank=None) for _ in range(4)]
    u = torch.zeros(h, hd, device="meta")
    state0 = torch.zeros(b, h, hd, hd, device="meta")
    scan.rwkv_scan.launches = 0
    with torch.no_grad():
        o, st = scan.rwkv_scan(*seq, u, state0)
    out[str(shape)] = {
        "types": [type(o).__name__, type(st).__name__],
        "shapes": [list(o.shape), list(st.shape)],
        "local": [list(o.to_local().shape), list(st.to_local().shape)],
        "placements": [[repr(p) for p in o.placements],
                       [repr(p) for p in st.placements]],
        "meta": o.to_local().is_meta and st.to_local().is_meta,
        "launches": scan.rwkv_scan.launches}
print(json.dumps(out))
"""


def test_rwkv_scan_dtensor_path_on_meta():
    """``rwkv_scan`` of DTensors under an 8-rank fake group on the meta
    device: each rank's shard (batch and heads kept, a plain zero state
    taken as replicated and cut to them), placements and shapes, and no
    launch; on (4, 2) and on (2, 2, 2) with the batch on two mesh dims."""
    proc = _run(["-c", RWKV_SCAN_META])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    b, s, h, hd = 8, 5, 4, 16
    for shape, rows in (("(4, 2)", 2), ("(2, 2, 2)", 2)):
        r = got[shape]
        assert r["types"] == ["DTensor", "DTensor"]
        assert r["shapes"] == [[b, s, h, hd], [b, h, hd, hd]]
        assert r["local"] == [[rows, s, h // 2, hd], [rows, h // 2, hd, hd]]
        assert r["meta"] and r["launches"] == 0
    assert got["(4, 2)"]["placements"] == [
        ["Shard(dim=0)", "Shard(dim=2)"], ["Shard(dim=0)", "Shard(dim=1)"]]
    assert got["(2, 2, 2)"]["placements"] == [
        ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"],
        ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"]]
