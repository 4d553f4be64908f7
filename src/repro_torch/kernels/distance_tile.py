"""Pairwise squared distances.

:func:`distance_tile` is the port of the reference's Pallas kernel of the
same name (``src/repro/kernels/distance_tile.py``):
``d2 = max(|q|^2 + |p|^2 - 2 q.p, 0)`` for every pair of q [Nq, 3] and
p [Np, 3], float32 or bfloat16 inputs upcast to float32 before any
arithmetic, [Nq, Np] float32 out. On a CUDA tensor it launches the
hand-written kernel ``csrc/distance_tile.cu`` (built by
``kernels/build.py``); on a CPU tensor it runs :func:`distance_tile_plain`,
the same arithmetic in plain PyTorch (``ref.pairwise_d2``). There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import pairwise_d2

Tensor = torch.Tensor
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    fn = load("distance_tile").distance_tile_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def distance_tile(q: Tensor, p: Tensor) -> Tensor:
    """Pairwise squared distances [Nq, Np] float32 of ``q`` [Nq, 3] and
    ``p`` [Np, 3], both float32 or both bfloat16."""
    for name, t in (("q", q), ("p", p)):
        if t.dtype not in DTYPES or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"distance_tile: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 or "
                             "bfloat16 [N, 3]")
    if q.dtype != p.dtype or q.device != p.device:
        raise ValueError(f"distance_tile: q is {q.dtype} on {q.device}, p "
                         f"is {p.dtype} on {p.device}")
    if q.device.type == "cpu":
        return distance_tile_plain(q, p)
    if q.device.type != "cuda":
        raise ValueError(f"distance_tile: no kernel for {q.device}")
    if not (q.is_contiguous() and p.is_contiguous()):
        raise ValueError("distance_tile: tensors must be contiguous")
    nq, n_p = q.shape[0], p.shape[0]
    if max(nq, n_p) >= 2 ** 31:
        raise ValueError("distance_tile: too many rows for int32")
    out = torch.empty((nq, n_p), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    launch = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), p.data_ptr(), nq, n_p,
                     int(q.dtype == torch.bfloat16), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"distance_tile: kernel launch failed "
                           f"(cudaError {err})")
    distance_tile.launches += 1
    return out


distance_tile.launches = 0


def distance_tile_plain(q: Tensor, p: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`distance_tile`: upcast, then
    ``ref.pairwise_d2``, whose sums are written out x, y, z as the kernel
    takes them."""
    return pairwise_d2(q.to(torch.float32), p.to(torch.float32))
