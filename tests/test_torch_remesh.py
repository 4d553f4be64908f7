"""``train.remesh`` and the rules' DTensor placements on real ranks: 8 gloo
CPU processes, spawned once for the file (a ``FileStore`` under a
temporary directory, loopback only), each running every case and
writing its results; each test reads its case's results.

- the reference's ``test_remesh_elastic`` case: ``{"w": arange(32)
  .reshape(8, 4)}`` with spec ``("data", None)`` placed on an (8,) mesh,
  then on a (4,) mesh (ranks 0-3) by ``remesh``: the whole tensor comes
  back equal, each rank of the (4,) mesh holds rows 2r, 2r+1, and ranks
  4-7 hold an empty shard;
- a smoke model's parameters placed by ``sharding.rules`` on a (4, 2)
  mesh (``param_pspecs``, train profile): each rank's local shard is
  exactly the slice its spec names (mesh coordinates major to minor), and
  the round trip back to whole tensors is bitwise.
"""
import json
import os
import time
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

WORLD = 8
SPAWN_TIMEOUT_S = 180


def _expected_slice(full, spec, mesh_names, coord):
    """The block of ``full`` that the rank at mesh coordinates ``coord``
    holds under ``spec``: per tensor dim, its axes' coordinates combined
    major to minor."""
    idx = []
    for d, size in enumerate(full.shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, pos = 1, 0
        for a in axes:
            k = mesh_names.index(a)
            pos = pos * coord[k][1] + coord[k][0]
            n *= coord[k][1]
        step = size // n
        idx.append(slice(pos * step, (pos + 1) * step))
    return full[tuple(idx)]


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import P, param_pspecs
    from repro_torch.train import remesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    out = {}
    try:
        # the reference's elastic case
        x = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
        specs = {"w": P("data", None)}
        mesh_a = make_test_mesh((8,), ("data",))
        mesh_b = make_test_mesh((4,), ("data",))
        xa = remesh(x, mesh_a, specs)
        xb = remesh(xa, mesh_b, specs)
        local_a = xa["w"].to_local()
        local_b = xb["w"].to_local()
        full_b = xb["w"].full_tensor() if rank < 4 else None
        out["elastic"] = {
            "a_rows": local_a.tolist(),
            "b_rows": local_b.tolist(),
            "b_full_equal": (None if full_b is None else
                             bool(torch.equal(full_b, x["w"])))}

        # a smoke model placed by the rules on (4, 2)
        cfg = smoke_config(get_config("qwen1.5-110b"))
        model = TM.init_params(cfg, seed=0, device="cpu")
        params = {n: p.detach() for n, p in model.named_parameters()}
        mesh = make_test_mesh((4, 2), ("data", "model"))
        pspecs = param_pspecs(params, mesh)
        placed = remesh(params, mesh, pspecs)
        names = list(mesh.mesh_dim_names)
        coord = [(int(c), int(s)) for c, s in
                 zip(mesh.get_coordinate(), mesh.shape)]
        bad, sharded = [], 0
        for name, p in params.items():
            local = placed[name].to_local()
            want = _expected_slice(p, pspecs[name], names, coord)
            if not torch.equal(local, want):
                bad.append(name)
            sharded += local.numel() < p.numel()
        back = remesh(placed, mesh, {n: P() for n in params})
        round_trip = all(torch.equal(back[n].to_local(), p)
                         for n, p in params.items())
        out["rules"] = {"bad": bad, "sharded": sharded,
                        "n": len(params), "round_trip": round_trip,
                        "coord": coord}
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawns the 8 ranks once; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("remesh")
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
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{WORLD} gloo ranks did not finish in "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert all(not p.is_alive() for p in ctx.processes)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_remesh_elastic_across_mesh_shapes(ranks):
    full = torch.arange(32, dtype=torch.float32).reshape(8, 4).tolist()
    for r, res in enumerate(ranks):
        e = res["elastic"]
        assert e["a_rows"] == [full[r]]
        if r < 4:
            assert e["b_rows"] == full[2 * r: 2 * r + 2]
            assert e["b_full_equal"] is True
        else:
            assert e["b_rows"] == [] and e["b_full_equal"] is None


def test_rules_place_each_rank_its_slice(ranks):
    coords = set()
    for res in ranks:
        rules = res["rules"]
        assert rules["bad"] == []
        assert rules["round_trip"] is True
        assert 0 < rules["sharded"] <= rules["n"]
        coords.add(tuple(c for c, _ in rules["coord"]))
    assert coords == {(i, j) for i in range(4) for j in range(2)}
