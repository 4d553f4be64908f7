"""Slab meshes for the sharded-scene subsystem (the reference's
``launch/mesh.py``).

The reference places each slab of a sharded scene on a JAX device of a
``jax.sharding.Mesh`` and exchanges halos with ``ppermute``. Here a mesh
is a named shape, a device and an optional rank layout: :class:`SlabMesh`
reads ``mesh.shape[axis]`` as JAX's ``Mesh.shape[axis]`` does.

Without a rank layout every slab lives in this process on ``device``,
the slab axis a leading tensor dimension. With one (``ranks``, a
``DeviceMesh`` over the default ``torch.distributed`` group whose dims
are named like the mesh's axes and divide their sizes), the ``r``-th
rank of an axis of ``n`` items holds items ``[r n / R, (r + 1) n / R)``
on its own device: its slabs, or its query columns. A dim of the layout
that names no axis of the mesh holds replicas: the ranks along it run
the same blocks independently. :meth:`SlabMesh.block` says what a rank
holds and who its neighbours are; ``core/shards.py`` sends halos and
migrating rows to them.

:func:`make_mesh_compat` and :func:`make_slab_mesh` build that layout
when a process group of more than one rank is initialized (one slab per
rank by default, as the reference's one slab per device), each rank on
its own card ``cuda:<LOCAL_RANK>`` (gloo ranks on the CPU only when the
caller asks for ``device="cpu"``). With no group, or a one-rank group,
the slabs share this process's device, and more slabs than devices share
it (the reference raises there and asks for forced host devices).

    torchrun --nproc-per-node 4 my_sim.py     # in my_sim.py:
    torch.distributed.init_process_group("nccl")
    sess = ShardedSession(points, params, mesh=make_slab_mesh())

The LM's meshes (:func:`make_production_mesh`, :func:`make_test_mesh`)
are ``torch.distributed`` ``DeviceMesh``es over the default process
group, with the reference's shapes and axis names: a pod of 16 x 16 =
256 ranks ("data", "model"), two pods of 2 x 16 x 16 = 512 ranks ("pod",
"data", "model"; the leading axis pure data parallelism). They need that
many ranks: a launcher that starts them, or the dry run's fake process
group (``python -m repro_torch.launch.dryrun``), which builds the meshes
in one process without devices.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..core.api import resolve_device


@dataclasses.dataclass(frozen=True)
class AxisBlock:
    """The items ``[first, first + count)`` of a mesh axis of ``size``
    items that this rank holds. ``group`` is the axis's process group
    (None: the whole axis is in this process), ``n_ranks`` its ranks, and
    ``left`` / ``right`` the global ranks that hold items ``first - 1`` and
    ``first + count`` (None at the mesh edge)."""

    size: int
    first: int
    count: int
    group: object = None
    n_ranks: int = 1
    left: int | None = None
    right: int | None = None


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """A named mesh shape (axis name -> size) on ``device``, and an
    optional rank layout ``ranks`` (a ``DeviceMesh``): without one every
    slab lives in this process."""

    shape: dict
    device: torch.device
    ranks: object = None

    def block(self, axis: str) -> AxisBlock:
        """What this rank holds of ``axis``: all of it without a rank
        layout or when the layout does not split it."""
        n = int(self.shape[axis])
        dm = self.ranks
        if dm is None or axis not in (dm.mesh_dim_names or ()):
            return AxisBlock(size=n, first=0, count=n)
        d = dm.mesh_dim_names.index(axis)
        coord = dm.get_coordinate()
        if coord is None:
            raise RuntimeError(
                f"rank {_rank()} is not in the mesh's rank layout")
        r, c = int(dm.size(d)), int(coord[d])
        per = n // r

        def peer(cc):
            at = list(coord)
            at[d] = cc
            return int(dm.mesh[tuple(at)])

        return AxisBlock(size=n, first=c * per, count=per,
                         group=dm.get_group(axis), n_ranks=r,
                         left=peer(c - 1) if c > 0 else None,
                         right=peer(c + 1) if c < r - 1 else None)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    """Ranks in the default process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _auto_layout(shape: tuple, axes: tuple, world: int, kind: str):
    """One block per rank: ``world`` ranks spread over the axes major to
    minor, each axis taking the largest share that divides its size, on
    devices of ``kind``; ValueError where they do not divide the mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    left, dims, names = world, [], []
    for n, a in zip(shape, axes):
        r = math.gcd(left, n)
        left //= r
        if r > 1:
            dims.append(r)
            names.append(a)
    if left != 1:
        raise ValueError(f"{world} ranks do not divide the mesh "
                         f"{dict(zip(axes, shape))} into equal blocks")
    return DeviceMesh(kind, torch.arange(world).reshape(dims),
                      mesh_dim_names=tuple(names))


def _check_layout(shape: tuple, axes: tuple, ranks) -> None:
    """ValueError unless each dim of ``ranks`` that names an axis divides
    its size and numbers its ranks in increasing order (the order in which
    a gather over its group returns the blocks)."""
    for d, name in enumerate(ranks.mesh_dim_names or ()):
        if name not in axes:
            continue
        r, n = int(ranks.mesh.shape[d]), shape[axes.index(name)]
        if n % r:
            raise ValueError(f"{r} ranks on axis {name!r} do not divide "
                             f"its {n} items")
        if not bool((torch.diff(ranks.mesh, dim=d) > 0).all()):
            raise ValueError(f"the ranks on axis {name!r} are not in "
                             "increasing order")


def _rank_device(device) -> torch.device:
    """This rank's device: its own card (``cuda:<LOCAL_RANK>``, made
    current), or the CPU when asked for; the layout's backend must carry
    tensors of that device, so no exchange goes through the host."""
    import torch.distributed as dist
    dev = resolve_device(device)
    backend = dist.get_backend()
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else _rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if "nccl" not in backend:
            raise ValueError(f"a rank layout on {dev} needs NCCL ranks, "
                             f"not {backend!r}")
    elif "gloo" not in backend:
        raise ValueError(f"a rank layout on {dev} needs gloo ranks, not "
                         f"{backend!r}")
    return dev


def make_mesh_compat(shape, axes, device="cuda", ranks=None) -> SlabMesh:
    """A mesh of ``shape`` over the named ``axes`` (the reference's
    ``jax.make_mesh`` wrapper). ``ranks`` is its rank layout; by default
    one block per rank of the default process group when that has more
    than one rank, else none (every slab on ``device``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    if ranks is None and _world() == 1:
        return SlabMesh(shape=dict(zip(axes, shape)),
                        device=resolve_device(device))
    dev = _rank_device(device)
    if ranks is None:
        ranks = _auto_layout(shape, axes, _world(), dev.type)
    _check_layout(shape, axes, ranks)
    return SlabMesh(shape=dict(zip(axes, shape)), device=dev, ranks=ranks)


def make_slab_mesh(n_slabs: int | None = None, axis: str = "data",
                   device="cuda", ranks=None) -> SlabMesh:
    """1-D slab mesh for the sharded-scene subsystem (``core/shards.py``).

    Defaults to one slab per rank when a process group of more than one
    rank is initialized, else to one slab per visible device of
    ``device``'s kind (one on the CPU), more slabs than devices sharing
    the device. ``ranks`` as in :func:`make_mesh_compat`.
    """
    if n_slabs is None:
        if ranks is not None or _world() > 1:
            n_slabs = (_world() if ranks is None else
                       int(ranks.size(ranks.mesh_dim_names.index(axis))))
        else:
            dev = resolve_device(device)
            n_slabs = (torch.cuda.device_count() if dev.type == "cuda"
                       else 1)
    return make_mesh_compat((n_slabs,), (axis,), device=device, ranks=ranks)


def _named_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` on ranks
    0 .. prod(shape) - 1 of the default process group (on "cuda" under
    NCCL, else on "cpu"); RuntimeError with fewer ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} in the default "
            "process group; start the program with that many ranks (e.g. "
            f"torchrun, {n} processes in all), or build the mesh in the dry "
            "run's fake process group (python -m repro_torch.launch.dryrun)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or with ``multi_pod`` (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return _named_mesh((2, 16, 16), ("pod", "data", "model"))
    return _named_mesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh for multi-rank tests."""
    return _named_mesh(shape, axes)


__all__ = ["AxisBlock", "SlabMesh", "make_mesh_compat", "make_slab_mesh",
           "make_production_mesh", "make_test_mesh"]
