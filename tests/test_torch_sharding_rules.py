"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX reference's (``repro.sharding.rules``), on the ten configs at full
size: the reference's parameter, optimizer and cache trees from
``jax.eval_shape`` at bfloat16, the port's built on the meta device.

The reference stacks each period's layers on a leading axis; the port
holds one tensor per layer and applies the rules to that layer's own
shape. So every port spec is held to the reference's function applied to
the same per-layer shape (its stacked leaves unstacked by name with
``convert.lm_arrays_by_name``, as zero-stride numpy views, so nothing
full-size is allocated), on four meshes ((16, 16), (2, 16, 16) with
"pod", (4, 2), and data-only (8,)) and both profiles. The reference gets
stand-in meshes with ``axis_names`` and ``shape``, the port plain named
shapes; specs compare with trailing Nones stripped.

Also: the reference's misfire on its stacked layer axis, shown exactly
(11 leaves on (16, 16), ROADMAP §3), activation specs captured from the
reference's ``with_sharding_constraint``, ``batch_pspec``, the DTensor
placements of a spec, and ``P``'s printing.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sharding.rules as JR
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.models.config import get_config as j_get
from repro.models.model import init_decode_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs import ALL_ARCHS, SHAPES, applicable
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.sharding import rules as TR
from repro_torch.train import optimizer as TO

MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 4, "model": 2},
          "data8": {"data": 8}}
PROFILES = ("train", "serve")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (its work is many small
    calls; the test workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(axes: dict):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def _view(s):
    """A zero-stride numpy stand-in of ``s``'s shape and dtype."""
    return np.broadcast_to(np.zeros((), s.dtype), s.shape)


def _norm(spec) -> tuple:
    spec = tuple(spec)
    n = len(spec)
    while n and spec[n - 1] is None:
        n -= 1
    return spec[:n]


def _path(name: str):
    return tuple(jax.tree_util.DictKey(k) for k in name.split("."))


@functools.cache
def _ref_params(arch: str):
    return jax.eval_shape(
        lambda k: j_init_params(j_get(arch), k, jnp.bfloat16),
        jax.random.PRNGKey(0))


@functools.cache
def _port_params(arch: str):
    return TM.init_params(get_config(arch), dtype=torch.bfloat16,
                          device="meta")


def _ref_by_name(arch: str, tree) -> dict:
    """The reference tree's leaves (or quantized moments) by the port's
    parameter names, each at its layer's own shape."""
    return convert.lm_arrays_by_name(get_config(arch),
                                     jax.tree.map(_view, tree))


def test_p_prints_and_compares_as_partition_spec():
    from jax.sharding import PartitionSpec
    spec = TR.P(("pod", "data"), None, "model", None)
    assert repr(spec) == repr(PartitionSpec(("pod", "data"), None, "model",
                                            None))
    assert spec == TR.P(("pod", "data"), None, "model")
    assert hash(spec) == hash(TR.P(("pod", "data"), None, "model"))
    assert TR.P() == TR.P(None, None) and TR.P("data") != TR.P("model")
    assert _norm(spec) == (("pod", "data"), None, "model")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_pspecs_match_reference_per_layer(arch):
    assert ALL_ARCHS == J_ARCHS
    model = _port_params(arch)
    ref = _ref_by_name(arch, _ref_params(arch))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(a.shape) for n, a in ref.items()}
    for mesh_name, axes in MESHES.items():
        for profile in PROFILES:
            got = TR.param_pspecs(model, axes, profile)
            for name, a in ref.items():
                want = JR.param_pspec(_path(name), a, _stand_in(axes),
                                      profile)
                assert _norm(got[name]) == _norm(want), (
                    mesh_name, profile, name, got[name], want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_opt_pspecs_match_reference_per_layer(arch):
    """Plain and int8 moments: shapes and dtypes of ``opt_state_specs``
    (meta tensors) equal the reference's ``eval_shape`` by name, and every
    spec equals the reference's ``opt_pspecs`` over the per-layer tree."""
    from repro_torch.train import opt_state_specs
    model = _port_params(arch)
    ref_params = _ref_params(arch)
    for quant in (False, True):
        ocfg = TO.OptConfig(quantize_moments=quant)
        port = opt_state_specs(model, ocfg)
        ref = jax.eval_shape(
            lambda p: JO.init_opt_state(p, JO.OptConfig(
                quantize_moments=quant)), ref_params)
        assert port["step"].dtype == torch.int32 and port["step"].shape == ()
        assert port["step"].device.type == "meta"
        for key in ("m", "v"):
            by_name = _ref_by_name(arch, ref[key])
            assert set(by_name) == set(port[key])
            for name, want in by_name.items():
                got = port[key][name]
                pairs = ([(got["code"], want["code"]),
                          (got["scale"], want["scale"])] if quant
                         else [(got, want)])
                for g, w in pairs:
                    assert tuple(g.shape) == w.shape, (name, g.shape)
                    assert str(g.dtype).split(".")[-1] == str(w.dtype)
        # specs over the per-layer tree, the reference's names kept
        per_layer = {"step": jax.ShapeDtypeStruct((), jnp.int32),
                     "m": _nest(_ref_by_name(arch, ref["m"])),
                     "v": _nest(_ref_by_name(arch, ref["v"]))}
        for mesh_name, axes in MESHES.items():
            want = JR.opt_pspecs(per_layer, _stand_in(axes))
            got = TR.opt_pspecs(port, axes)
            assert _norm(got["step"]) == _norm(want["step"]) == ()
            for key in ("m", "v"):
                flat = _flat(want[key])
                for name, spec in got[key].items():
                    if quant:
                        for part in ("code", "scale"):
                            assert _norm(spec[part]) == _norm(
                                flat[f"{name}.{part}"]), (mesh_name, name,
                                                          part)
                    else:
                        assert _norm(spec) == _norm(flat[name]), (
                            mesh_name, name, spec, flat[name])


def _nest(by_name: dict) -> dict:
    """``{"a.b.c": leaf}`` as nested dicts (keys kept as strings)."""
    out: dict = {}
    for name, leaf in by_name.items():
        node = out
        *parents, last = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(str(p.key) for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_pspecs_match_reference_per_layer(arch):
    """``decode_32k`` (B 128) and ``long_500k`` (B 1) caches where
    ``applicable``: the port's per-layer cache (meta) against the
    reference's ``cache_pspecs`` over its cache unstacked by layer. A
    host-int ``length`` takes no spec."""
    cfg = get_config(arch)
    ran = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not applicable(cfg, shape)[0]:
            continue
        ran += 1
        b, s = shape.global_batch, shape.seq_len
        port = TM.init_decode_cache(cfg, b, s, torch.bfloat16,
                                    device="meta")
        ref = jax.eval_shape(
            lambda: j_init_cache(j_get(arch), b, s, jnp.bfloat16))
        ref_layers = convert._unstack(jax.tree.map(_view, ref), cfg)
        assert len(ref_layers) == len(port)
        for mesh_name, axes in MESHES.items():
            want = JR.cache_pspecs(ref_layers, _stand_in(axes), b)
            got = TR.cache_pspecs(port, axes, b)
            for li, (g_layer, w_layer) in enumerate(zip(got, want)):
                w_flat = _flat(w_layer)
                g_flat = {}
                _flat_port(g_layer, "", g_flat)
                assert set(g_flat) == set(w_flat), (li, g_flat, w_flat)
                for name, spec in g_flat.items():
                    if name.endswith("length"):
                        assert spec is None
                        continue
                    assert _norm(spec) == _norm(w_flat[name]), (
                        shape_name, mesh_name, li, name)
    assert ran >= 1 or cfg.enc_dec


def _flat_port(node, prefix: str, out: dict) -> None:
    for k, v in node.items():
        if isinstance(v, dict):
            _flat_port(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v


def test_reference_stacked_rules_misfire_on_the_layer_axis():
    """The reference's stacked specs put a mesh axis on the layer dim of
    exactly these 11 body leaves on (16, 16) (a rank-2 weight stacked to
    rank 3 takes a rank-3 rule of the same name); on every other body
    leaf the stacked spec minus its leading None is the per-layer spec
    the port gives."""
    expected = {
        "rwkv6-7b": {"ffn/wk", "ffn/wv", "mixer/wk", "mixer/wv",
                     "mixer/wo"},
        "qwen1.5-110b": {"ffn/w_gate", "ffn/w_up", "ffn/w_down"},
        "command-r-plus-104b": {"ffn/w_gate", "ffn/w_up", "ffn/w_down"}}
    axes = MESHES["pod"]
    found, n_body = {}, 0
    for arch in ALL_ARCHS:
        tree = _ref_params(arch)
        specs = JR.param_pspecs(tree, _stand_in(axes))
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, leaf), spec in zip(leaves, spec_leaves):
            if getattr(path[0], "key", None) != "body":
                continue
            n_body += 1
            keys = [p.key for p in path[2:]]
            if _norm(spec) and spec[0] is not None:
                found.setdefault(arch, set()).add("/".join(keys))
                continue
            port = TR.param_pspec(keys[-1], leaf.shape[1:], axes)
            assert _norm(tuple(spec)[1:]) == _norm(port), (arch, keys)
    assert found == expected
    assert sum(map(len, found.values())) == 11 and n_body == 151


def _capture_ref_specs(monkeypatch):
    """The reference's ``make_shard_fn`` with its constraint captured: the
    spec it would hand to ``with_sharding_constraint`` (None where it
    returns x untouched)."""
    seen = []
    monkeypatch.setattr(JR, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)

    def spec_of(fn, shape, name):
        seen.clear()
        fn(jax.ShapeDtypeStruct(shape, jnp.float32), name)
        return seen[0] if seen else None
    return spec_of


ACT_CASES = [
    ("act_resid", (32, 7, 64)), ("act_resid", (3, 7, 64)),
    ("act_resid", (32, 7)), ("act_heads", (32, 7, 16, 8)),
    ("act_heads", (5, 7, 6, 8)), ("act_ffn", (32, 7, 48)),
    ("act_ffn", (32, 7, 47)), ("attn_logits", (64, 8, 2, 7, 7)),
    ("attn_logits", (4, 6, 2, 7, 7)), ("attn_logits4", (64, 32, 7, 7)),
    ("attn_logits4", (64, 6, 7, 7)), ("logits", (32, 7, 256)),
    ("logits", (1, 1, 255)), ("logits_last", (32, 256)),
    ("logits_last", (3, 100)), ("moe_dispatch", (16, 40, 64)),
    ("moe_dispatch", (8, 40, 64)), ("moe_ffn", (16, 40, 96)),
    ("moe_ffn", (6, 40, 96)), ("act_heads", (32, 7, 16)),
    ("unknown", (32, 7, 64)), ("logits", (32, 256)),
]


def test_activation_specs_match_reference(monkeypatch):
    spec_of = _capture_ref_specs(monkeypatch)
    for axes in MESHES.values():
        ref_fn = JR.make_shard_fn(_stand_in(axes))
        port_fn = TR.make_shard_fn(axes)
        assert port_fn.model_size == ref_fn.model_size
        for name, shape in ACT_CASES:
            want = spec_of(ref_fn, shape, name)
            got = port_fn.spec(shape, name)
            if want is None:
                assert got is None, (axes, name, shape)
            else:
                assert _norm(got) == _norm(want), (axes, name, shape, got)


def test_shard_fn_leaves_plain_tensors_alone():
    shard = TR.make_shard_fn(MESHES["small"])
    x = torch.ones(4, 3, 8)
    for name in ("act_resid", "act_ffn", "logits", "other"):
        assert shard(x, name) is x


@pytest.mark.parametrize("batch", [256, 96, 16, 1])
def test_batch_axes_and_pspec_match_reference(batch):
    for axes in MESHES.values():
        m = _stand_in(axes)
        assert TR.batch_axes(axes) == JR.batch_axes(m)
        for extra in (1, 2):
            assert _norm(TR.batch_pspec(axes, batch, extra)) == _norm(
                JR.batch_pspec(m, batch, extra))


def test_mesh_shape_reads_device_mesh_and_mappings():
    assert TR.mesh_shape({"data": 4, "model": 2}) == {"data": 4, "model": 2}
    assert TR.mesh_shape(_stand_in({"data": 8})) == {"data": 8}
    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data"),
                                 shape=torch.Size([2, 4]))
    assert TR.mesh_shape(fake) == {"pod": 2, "data": 4}
    with pytest.raises(TypeError):
        TR.mesh_shape((4, 2))


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TR.placements(TR.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TR.placements(TR.P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert TR.placements(TR.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        TR.placements(TR.P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        TR.placements(TR.P("data", "data"), mesh)
