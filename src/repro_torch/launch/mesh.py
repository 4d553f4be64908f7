"""Slab meshes for the sharded-scene subsystem (the reference's
``launch/mesh.py``).

The reference places each slab of a sharded scene on a JAX device of a
``jax.sharding.Mesh`` and exchanges halos with ``ppermute``. The port runs
the slabs in one process, with the slab axis as the leading dimension of
its tensors on one device, so a mesh here is a named shape and a device:
:class:`SlabMesh` reads ``mesh.shape[axis]`` as JAX's ``Mesh.shape[axis]``
does.

:func:`make_slab_mesh` accepts more slabs than devices: the slabs share
the device. The reference raises there and asks for forced host devices
(``--xla_force_host_platform_device_count``). Placing slabs on several
cards is not done yet.

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

import torch

from ..core.api import resolve_device


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """A named mesh shape (axis name -> size) whose slabs all live on
    ``device``."""

    shape: dict
    device: torch.device


def make_mesh_compat(shape, axes, device="cuda") -> SlabMesh:
    """A mesh of ``shape`` over the named ``axes`` on ``device`` (the
    reference's ``jax.make_mesh`` wrapper)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    return SlabMesh(shape=dict(zip(axes, shape)),
                    device=resolve_device(device))


def make_slab_mesh(n_slabs: int | None = None, axis: str = "data",
                   device="cuda") -> SlabMesh:
    """1-D slab mesh for the sharded-scene subsystem (``core/shards.py``).

    Defaults to one slab per visible device of ``device``'s kind (one on
    the CPU); more slabs than devices share the device.
    """
    dev = resolve_device(device)
    if n_slabs is None:
        n_slabs = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh_compat((n_slabs,), (axis,), device=dev)


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


__all__ = ["SlabMesh", "make_mesh_compat", "make_slab_mesh",
           "make_production_mesh", "make_test_mesh"]
