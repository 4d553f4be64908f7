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
cards is not done yet. The LM's production and test meshes
(``make_production_mesh``, ``make_test_mesh``) wait for the LM sharding
slice.
"""
from __future__ import annotations

import dataclasses

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


__all__ = ["SlabMesh", "make_mesh_compat", "make_slab_mesh"]
