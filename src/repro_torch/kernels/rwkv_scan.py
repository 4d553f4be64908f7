"""RWKV-6 recurrence with the state held on chip.

:func:`rwkv_scan` is the port of the reference's Pallas kernel of the same
name (``src/repro/kernels/rwkv_scan.py``). Per (batch, head), with the
``[hd, hd]`` float32 state S (row i the k index, column j the v index)::

    out_t = r_t (S + u * k_t^T v_t) ;  S <- diag(w_t) S + k_t^T v_t

r/k/v/w are [B, S, H, hd], u [H, hd] (broadcast over B), state0
[B, H, hd, hd]; every input is upcast to float32 and both outputs are
float32; any head dim. On a CUDA tensor it launches the hand-written
kernel ``csrc/rwkv_scan.cu`` (built by ``kernels/build.py``), which reads
the inputs in place through their strides and splits each head's columns
over several CTAs (:func:`scan_plan`); on a CPU tensor it runs
:func:`rwkv_scan_plain`, the reference's ``_rwkv_scan_core``
(``src/repro/models/layers.py``) as a loop over t. There is no fallback
from one to the other. On the meta device it only gives the outputs'
shapes (the dry run). The kernel has no backward (nor has the
reference's, its inference and prefill fast path), so the wrapper refuses
inputs that autograd would need a gradient of, on every device: training
runs ``models.layers.rwkv_chunked_core``.

On DTensors (serving on a mesh) every (batch, head) pair recurs alone,
so each rank calls the same wrapper on its own shard
(:func:`_rwkv_scan_dtensor`): the kernel on a card, the plain version on
the CPU, shapes on the meta device; one launch a rank and a call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

Tensor = torch.Tensor
PANEL = 128          # most state rows a CTA holds in registers at once
ROWS_PER_LANE = 8    # state rows a lane holds where 8 row groups allow
COLS_PER_LANE = 4    # state columns a lane holds (the kernel's kCols)
WARPS_PER_CTA = 2    # warps a CTA, side by side in columns (kWarps)


def scan_plan(hd: int) -> tuple[int, int, int, int, int, int]:
    """How the kernel lays out a head of width ``hd``: ``(groups, rows,
    cols_per_lane, warps, cols, panels)``. A warp is ``32 / groups``
    column groups of ``cols_per_lane`` columns, a CTA ``warps`` warps side
    by side, ``cols`` columns in all; a lane holds ``rows / groups`` rows of
    its columns (at most ROWS_PER_LANE where 8 row groups allow, else up
    to 16), ``rows`` rows of a panel in all (zero past hd); a head runs
    ``ceil(hd / cols)`` CTAs, each over ``panels`` panels of rows in
    turn."""
    want = min(hd, PANEL)
    groups = 1
    while groups * ROWS_PER_LANE < want and groups < 8:
        groups *= 2
    per_lane = -(-want // groups)
    rows = groups * (-(-per_lane // 4) * 4)
    nct, nw = COLS_PER_LANE, WARPS_PER_CTA
    return (groups, rows, nct, nw, nw * (32 // groups) * nct,
            -(-hd // rows))


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load
    fn = load("rwkv_scan").rwkv_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, *([ll] * 12), p, p, i, i, i, i, i, i, i, i,
                   p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state0) -> None:
    if r.dim() != 4:
        raise ValueError(f"rwkv_scan: r is {tuple(r.shape)}, expected "
                         "[B, S, H, hd]")
    b, _s, h, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"rwkv_scan: {name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"rwkv_scan: u is {tuple(u.shape)}, expected "
                         f"{(h, hd)}")
    if state0.shape != (b, h, hd, hd):
        raise ValueError(f"rwkv_scan: state0 is {tuple(state0.shape)}, "
                         f"expected {(b, h, hd, hd)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state0", state0)):
        if not t.is_floating_point():
            raise ValueError(f"rwkv_scan: {name} is {t.dtype}, expected a "
                             "floating dtype")
        if t.device != r.device:
            raise ValueError(f"rwkv_scan: {name} is on {t.device}, r on "
                             f"{r.device}")


def rwkv_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              state0: Tensor) -> tuple[Tensor, Tensor]:
    """r/k/v/w [B, S, H, hd], u [H, hd], state0 [B, H, hd, hd] ->
    (out [B, S, H, hd], state_T [B, H, hd, hd]), both float32. Where any
    input is a DTensor, both outputs are DTensors
    (:func:`_rwkv_scan_dtensor`)."""
    from torch.distributed.tensor import DTensor

    _check(r, k, v, w, u, state0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state0)):
        raise RuntimeError(
            "rwkv_scan has no backward: an input requires a gradient (train "
            "through models.layers.rwkv_chunked_core, or call under "
            "torch.no_grad())")
    if any(isinstance(t, DTensor) for t in (r, k, v, w, u, state0)):
        return _rwkv_scan_dtensor(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, state0)
    if r.device.type == "meta":
        # shapes only (the dry run): neither the kernel nor the plain
        # version runs, and no FLOPs are counted for the recurrence
        b, s, h, hd = r.shape
        return (torch.empty((b, s, h, hd), dtype=torch.float32,
                            device=r.device),
                torch.empty((b, h, hd, hd), dtype=torch.float32,
                            device=r.device))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan: no kernel for {r.device}")
    b, s, h, hd = r.shape
    if b * h >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError("rwkv_scan: B*H or S exceeds int32")

    def seq_input(t):
        t = t.to(torch.float32)
        return t if t.stride(-1) == 1 else t.contiguous()

    ins = [seq_input(t) for t in (r, k, v, w)]
    uf = u.to(torch.float32).contiguous()
    s0 = state0.to(torch.float32).contiguous()
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    s_t = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, s_t
    strides = [st for t in ins for st in t.stride()[:3]]
    groups, rows, nct, warps, _, _ = scan_plan(hd)
    launch = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(*(t.data_ptr() for t in ins), *strides, uf.data_ptr(),
                     s0.data_ptr(), b, s, h, hd, groups, rows // groups, nct,
                     warps, out.data_ptr(), s_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rwkv_scan: kernel launch failed "
                           f"(cudaError {err})")
    rwkv_scan.launches += 1
    return out, s_t


rwkv_scan.launches = 0


def per_head_placements(placements) -> tuple[list, list, list]:
    """The placements on which every (batch, head) pair recurs on one
    rank, from ``r``'s (``[B, S, H, hd]``): r/k/v/w keep only their batch
    (dim 0) and head (dim 2) shards, the rest replicated; ``u`` [H, hd]
    takes the head shards, the state [B, H, hd, hd] the batch and head
    shards (as ``sharding.rules.cache_pspecs`` places it)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [p if type(p) is Shard and p.dim in (0, 2) else Replicate()
          for p in placements]

    def shard_of(dims):          # r's batch / head shards on other dims
        return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                else Replicate() for p in pl]

    return pl, shard_of({2: 0}), shard_of({0: 0, 2: 1})


def _rwkv_scan_dtensor(r, k, v, w, u, state0) -> tuple[Tensor, Tensor]:
    """:func:`rwkv_scan` of DTensors (a plain input, such as a prefill's
    zero state, is taken as replicated): r/k/v/w are redistributed so that
    only their batch dim (0) and head dim (2) keep the shards that ``r``
    has (the sequence and the head width made whole, a partial sum
    reduced), ``u`` takes the head shards and ``state0`` the batch and head
    shards (``sharding.rules.cache_pspecs`` places a decode cache's state
    so), then each rank runs :func:`rwkv_scan` on its local shards. ``out``
    comes back with r's kept placements, ``state_T`` with state0's. A mesh
    dim that shards neither the batch nor the heads leaves every rank
    along it the same whole result: replicated, not partial."""
    from torch.distributed.tensor import DTensor, Replicate

    like = next(t for t in (r, k, v, w, u, state0)
                if isinstance(t, DTensor))
    mesh = like.device_mesh

    def placed(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl)

    pl, u_pl, s_pl = per_head_placements(
        r.placements if isinstance(r, DTensor) else
        [Replicate()] * mesh.ndim)
    r, k, v, w = (placed(t, pl) for t in (r, k, v, w))
    u, state0 = placed(u, u_pl), placed(state0, s_pl)
    out, state = rwkv_scan(r.to_local(), k.to_local(), v.to_local(),
                           w.to_local(), u.to_local(), state0.to_local())
    b, s, h, hd = r.shape
    return (DTensor.from_local(out, mesh, pl, run_check=False,
                               shape=(b, s, h, hd),
                               stride=(s * h * hd, h * hd, hd, 1)),
            DTensor.from_local(state, mesh, s_pl, run_check=False,
                               shape=(b, h, hd, hd),
                               stride=(h * hd * hd, hd * hd, hd, 1)))


def rwkv_scan_plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    state0: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`rwkv_scan`: the reference's
    ``_rwkv_scan_core``, the same einsum in a loop over t."""
    r, k, v, w, u, state = (t.to(torch.float32)
                            for t in (r, k, v, w, u, state0))
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # [B,H,hd]
        kv = k_t[..., :, None] * v_t[..., None, :]               # [B,H,hd,hd]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t,
                                 state + u[..., None] * kv))
        state = w_t[..., None] * state + kv
    out = (torch.stack(outs, dim=1) if outs else
           torch.zeros_like(r))
    return out, state
