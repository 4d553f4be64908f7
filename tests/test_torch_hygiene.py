"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points default to the card."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_reference():
    names = _modules()
    assert {"repro_torch.api", "repro_torch.convert",
            "repro_torch.kernels.knn_tile", "repro_torch.kernels.build",
            "repro_torch.core.grid", "repro_torch.core.dynamic",
            "repro_torch.obs", "repro_torch.kernels.update_tile",
            "repro_torch.core.bundle", "repro_torch.core.executor",
            "repro_torch.kernels.range_tile",
            "repro_torch.kernels.distance_tile",
            "repro_torch.reliability.faults", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.model",
            "repro_torch.configs", "repro_torch.kernels.rwkv_scan",
            "repro_torch.train.serve_step",
            "repro_torch.launch.serve_lm", "repro_torch.core.shards",
            "repro_torch.core.distributed",
            "repro_torch.launch.mesh", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.train.checkpoint",
            "repro_torch.train.fault_tolerance",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.configs.lm_100m", "repro_torch.configs.command_r_35b",
            "repro_torch.configs.command_r_plus_104b",
            "repro_torch.configs.qwen1_5_110b",
            "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.grok_1_314b",
            "repro_torch.configs.deepseek_v3_671b",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.whisper_tiny",
            "repro_torch.sharding", "repro_torch.sharding.rules",
            "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis"
            } <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr



def test_torch_examples_import_no_jax_and_no_reference():
    """``examples/*_torch.py`` name no ``jax`` and nothing of ``repro.`` in
    an import statement, and the three with a ``main`` guard load neither
    when imported."""
    import ast
    examples = sorted((SRC.parent / "examples").glob("*_torch.py"))
    assert {p.name for p in examples} >= {
        "sph_fluid_torch.py", "quickstart_torch.py",
        "pointcloud_pipeline_torch.py", "train_lm_torch.py"}
    for path in examples:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path.name, mod)
    guarded = [str(p) for p in examples
               if "if __name__ == \"__main__\":" in p.read_text()]
    assert len(guarded) >= 3
    code = (
        "import importlib.util, sys\n"
        f"for i, path in enumerate({guarded!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

def test_build_index_defaults_to_cuda():
    """Without a CUDA device and without ``device="cpu"``, ``build_index``
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.api import SearchParams, build_index
    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(pts, SearchParams(radius=0.2, k=4))
    index = build_index(pts, SearchParams(radius=0.2, k=4), device="cpu")
    assert index.points.device.type == "cpu"


def test_host_planned_entry_points_default_to_cuda():
    """``NeighborSearch`` and the one-shot ``neighbor_search`` raise without
    a CUDA device unless the caller passes ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.core import (NeighborSearch, SearchParams,
                                  neighbor_search)
    rng = np.random.default_rng(0)
    pts = rng.random((50, 3)).astype(np.float32)
    qs = rng.random((10, 3)).astype(np.float32)
    params = SearchParams(radius=0.2, k=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        NeighborSearch(pts, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        neighbor_search(pts, qs, 0.2, 4)
    ns = NeighborSearch(pts, params, device="cpu")
    assert ns.query(qs).indices.device.type == "cpu"
    res = neighbor_search(pts, qs, 0.2, 4, device="cpu")
    assert res.counts.device.type == "cpu"


def test_lm_entry_points_default_to_cuda():
    """Without a CUDA device, ``serve_lm`` without ``--device cpu`` and
    ``init_params`` on its default device raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import get_config, init_params
    cfg = smoke_config(get_config("rwkv6-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    assert next(init_params(cfg, device="cpu").parameters()).device.type \
        == "cpu"


def test_sharded_entry_points_default_to_cuda():
    """Without a CUDA device, ``make_slab_mesh``, ``shard_scene`` and
    ``ShardedSession`` raise unless the caller passes ``device="cpu"``
    (``make_mesh_compat`` too, which ``distributed_neighbor_search``
    takes its device from)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.core import SearchParams, ShardedSession, shard_scene
    from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh
    pts = np.random.default_rng(0).random((80, 3)).astype(np.float32)
    params = SearchParams(radius=0.2, k=4)
    for call in (lambda: make_slab_mesh(2),
                 lambda: make_mesh_compat((2, 2), ("data", "model")),
                 lambda: shard_scene(pts, params, n_slabs=2),
                 lambda: ShardedSession(pts, params, n_slabs=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    index = shard_scene(pts, params, n_slabs=2, device="cpu")
    assert index.pts.device.type == "cpu"
    sess = ShardedSession(pts, params, n_slabs=2, device="cpu")
    assert sess.step(pts).counts.device.type == "cpu"

    # a ranked mesh (a one-rank gloo group over an in-memory store): the
    # same, and its slabs stay on the CPU only when asked
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    saved = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        ranks = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        for call in (lambda: make_slab_mesh(2, ranks=ranks),
                     lambda: make_mesh_compat((2, 1), ("data", "model"),
                                              ranks=ranks)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        mesh = make_slab_mesh(2, ranks=ranks, device="cpu")
        assert mesh.ranks is ranks and mesh.device.type == "cpu"
        assert shard_scene(pts, params, mesh=mesh).pts.device.type == "cpu"
        sess = ShardedSession(pts, params, mesh=mesh)
        assert sess.step(pts).counts.device.type == "cpu"
    finally:
        dist.destroy_process_group()
        if saved is None:
            os.environ.pop("GLOO_SOCKET_IFNAME")
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = saved


def test_train_entry_points_default_to_cuda():
    """Without a CUDA device, ``make_batch``, ``synthetic_stream``,
    ``launch/train`` and ``convert.opt_state_from_arrays`` raise unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch, synthetic_stream
    from repro_torch.launch import train
    from repro_torch.models import get_config
    cfg = smoke_config(get_config("rwkv6-7b"))
    gen = torch.Generator().manual_seed(0)
    moment = {"embed": np.zeros((4, 2), np.float32),
              "body": [{"u": np.zeros((cfg.n_layers, 3), np.float32)}]}
    tree = {"step": np.zeros((), np.int32), "m": moment, "v": moment}
    for call in (lambda: make_batch(cfg, 2, 8, gen),
                 lambda: synthetic_stream(cfg, 2, 8),
                 lambda: train.main(["--arch", "rwkv6-7b", "--smoke",
                                     "--steps", "1"]),
                 lambda: convert.opt_state_from_arrays(cfg, tree)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert make_batch(cfg, 2, 8, gen, device="cpu")["tokens"].shape == (2, 8)
    assert next(synthetic_stream(cfg, 2, 8, device="cpu"))["mask"].device \
        .type == "cpu"
    state = convert.opt_state_from_arrays(cfg, tree, device="cpu")
    assert set(state["v"]) == {"embed", "blocks.0.u", "blocks.1.u"}
    assert state["m"]["blocks.1.u"].device.type == "cpu"
