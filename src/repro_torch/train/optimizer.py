"""AdamW with optional int8 block-quantized moments (the port of
``src/repro/train/optimizer.py``).

Parameters, gradients and moments are mappings by the model's parameter
names (``dict(model.named_parameters())``, the ``.grad`` of each). A
quantized moment is ``{"code": int8, "scale": float32}``: blocks of 256
along the last axis (padded), codes keeping the parameter's shape (its
last axis padded), scales that shape with the last axis replaced by the
block count; the second moment is quantized in sqrt-space with a decode
floor of one quantization step (the reference's documented bias: tiny
second moments get conservatively smaller steps). Rounding is half to
even in both frameworks, so codes equal the reference's on equal inputs.
A gradient that is None (a parameter no loss reaches) counts as zero.

The step counter, the learning rate and the clip factor stay on the
device, so a step fetches nothing to the host. :func:`apply_updates`
updates the parameters, and float32 moments, in place (under
``torch.no_grad``): a step then needs no second copy of either, only
one parameter's temporaries at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Collection, Mapping

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    warmup_steps: int = 100


# -- int8 blockwise quantization --------------------------------------------

def _blocks(x: Tensor) -> Tensor:
    """``x`` (0-d taken as [1]) padded with zeros along its last axis to a
    multiple of the block, as [..., n_blocks, _QBLOCK]."""
    if x.ndim == 0:
        x = x[None]
    xp = F.pad(x, (0, (-x.shape[-1]) % _QBLOCK))
    return xp.reshape(*xp.shape[:-1], xp.shape[-1] // _QBLOCK, _QBLOCK)


def _code_shape(blocks: Tensor) -> tuple[int, ...]:
    return (*blocks.shape[:-2], blocks.shape[-2] * _QBLOCK)


def _qencode(x: Tensor) -> dict[str, Tensor]:
    """Signed absmax int8 per block."""
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = blocks / scale
    code = q.round_().clamp_(-127, 127).to(torch.int8)
    return {"code": code.reshape(_code_shape(blocks)),
            "scale": scale[..., 0].to(torch.float32)}


def _decoded(q: Mapping[str, Tensor], values: Tensor, shape) -> Tensor:
    """Block values [..., n_blocks, _QBLOCK] back to ``shape``."""
    out = values.reshape(q["code"].shape)
    out = out[..., : shape[-1] if len(shape) else 1]
    return out.reshape(shape)


def _code_blocks(q: Mapping[str, Tensor]) -> Tensor:
    code = q["code"]
    return code.reshape(*code.shape[:-1], code.shape[-1] // _QBLOCK,
                        _QBLOCK).to(torch.float32)


def _qdecode(q: Mapping[str, Tensor], shape) -> Tensor:
    return _decoded(q, _code_blocks(q) * q["scale"][..., None], shape)


def _qencode_sqrt(x: Tensor) -> dict[str, Tensor]:
    """Non-negative values (second moments), quantized in sqrt-space. The
    root is taken in float64 and rounded once to float32, the correctly
    rounded float32 root (PyTorch's vectorised float32 root on the CPU is
    not: about 0.6 % of values differ by an ulp), so that scales and codes
    equal the reference's."""
    root = torch.clamp(x, min=0.0).to(torch.float64).sqrt_()
    blocks = _blocks(root.to(torch.float32))
    del root
    scale = torch.clamp(torch.amax(blocks, dim=-1, keepdim=True) / 127.0,
                        min=1e-20)
    q = blocks / scale
    code = q.round_().clamp_(0, 127).to(torch.int8)
    return {"code": code.reshape(_code_shape(blocks)),
            "scale": scale[..., 0].to(torch.float32)}


def _qdecode_sqrt(q: Mapping[str, Tensor], shape) -> Tensor:
    # decode floor of one quant step: bounds updates for zero-collapsed v.
    # A block that was all zero has scale 1e-20, whose square is subnormal
    # in float32: the reference's XLA flushes it to zero (on the CPU and
    # the TPU), so the port does too, or such a block (a parameter that
    # never gets a gradient) would encode 127s where the reference has 0s
    root = torch.clamp(_code_blocks(q), min=1.0) * q["scale"][..., None]
    sq = root * root
    sq = torch.where(sq < torch.finfo(torch.float32).tiny,
                     sq.new_zeros(()), sq)
    return _decoded(q, sq, shape)


# -- state -------------------------------------------------------------------

def init_opt_state(params: Mapping[str, Tensor] | torch.nn.Module,
                   cfg: OptConfig) -> dict[str, Any]:
    """``{"step": int32 0-d, "m": {name: moment}, "v": {name: moment}}`` on
    the parameters' devices, the moments zero. Where the parameters are
    DTensors, every moment leaf (an int8 ``code`` and ``scale`` included)
    is a DTensor on their mesh, placed by ``sharding.rules.opt_pspecs``
    (ZeRO-style, as the reference places its state); the step stays a
    plain tensor, the same on every rank."""
    params = _named(params)

    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _qencode(z) if cfg.quantize_moments else z

    dev = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": {n: zeros_like_moment(p) for n, p in params.items()},
             "v": {n: zeros_like_moment(p) for n, p in params.items()}}
    mesh = _mesh_of(params)
    return state if mesh is None else _place_moments(state, mesh)


def _mesh_of(params: Mapping[str, Tensor]):
    """The ``DeviceMesh`` of the first DTensor parameter, or None."""
    from torch.distributed.tensor import DTensor

    for p in params.values():
        if isinstance(p, DTensor):
            return p.device_mesh
    return None


def _place_moments(state: dict[str, Any], mesh) -> dict[str, Any]:
    """Every moment leaf of ``state`` (whole, the same on every rank) as a
    DTensor on ``mesh`` placed by ``opt_pspecs``; no communication."""
    from ..sharding.rules import opt_pspecs, place_tree

    specs = opt_pspecs(state, mesh)
    return {"step": state["step"],
            **{key: place_tree(state[key], mesh, specs[key])
               for key in ("m", "v")}}


def opt_state_specs(params: Mapping[str, Tensor] | torch.nn.Module,
                    cfg: OptConfig) -> dict[str, Any]:
    """The optimizer state of ``params`` built on the meta device: its
    names, shapes and dtypes, nothing allocated (the reference's
    ``eval_shape`` of ``init_opt_state``, for the dry run). A quantized
    moment takes :func:`_blocks`' layout; no quantization runs."""
    def moment(p):
        z = torch.empty(p.shape, dtype=torch.float32, device="meta")
        if not cfg.quantize_moments:
            return z
        blocks = _blocks(z)
        return {"code": torch.empty(_code_shape(blocks), dtype=torch.int8,
                                    device="meta"),
                "scale": torch.empty(blocks.shape[:-1],
                                     dtype=torch.float32, device="meta")}

    params = _named(params)
    return {"step": torch.zeros((), dtype=torch.int32, device="meta"),
            "m": {n: moment(p) for n, p in params.items()},
            "v": {n: moment(p) for n, p in params.items()}}


def _named(params) -> dict[str, Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _global_norm(tree: Mapping[str, Tensor | None]) -> Tensor:
    """The norm over every gradient; a None one adds nothing."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values() if g is not None))


def lr_at(cfg: OptConfig, step: Tensor) -> Tensor:
    """The warmed-up learning rate at ``step`` (a device tensor)."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(params: Mapping[str, Tensor] | torch.nn.Module,
                  grads: Mapping[str, Tensor], state: dict[str, Any],
                  cfg: OptConfig, *, stacked: Collection[str] = ()
                  ) -> tuple[dict[str, Tensor], dict[str, Any], dict]:
    """One AdamW step: the global gradient norm clipped to
    ``cfg.grad_clip``, bias-corrected moments, and weight decay on a
    parameter of two axes or more. A parameter named in ``stacked`` counts
    one axis more: the reference holds it stacked over its scanned layers
    (``models.model.scanned_params``), and decays it by that shape. A
    gradient that is None is a zero gradient.
    Parameters and float32 moments are updated in place. Returns (params,
    state, metrics), ``metrics`` the device scalars ``grad_norm`` and
    ``lr``."""
    from torch.distributed.tensor import DTensor

    params = _named(params)
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = lr_at(cfg, state["step"])
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    new_m, new_v = {}, {}
    for name, p in params.items():
        ndim = p.ndim + (name in stacked)
        wd = cfg.weight_decay if ndim >= 2 else 0.0
        upd = _update_dtensor if isinstance(p, DTensor) else _update
        new_m[name], new_v[name] = upd(
            p, grads[name], state["m"][name], state["v"][name], wd, clip,
            lr, b1c, b2c, cfg)
    return (params, {"step": step, "m": new_m, "v": new_v},
            {"grad_norm": gnorm, "lr": lr})


def _placed_as(x: Tensor, like: Tensor) -> Tensor:
    """DTensor ``x`` redistributed to ``like``'s placements."""
    if tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def _update_dtensor(p: Tensor, g: Tensor | None, m, v, *args):
    """:func:`_update` of a DTensor parameter. Float32 moments update
    shard by shard (the gradient redistributed to the moments' placements,
    the step to the parameter's): every operation is elementwise, so each
    element rounds as in the unsharded step. Int8 moments quantize in
    blocks along the last axis, which a shard need not align with: their
    parameter, gradient and moments are gathered whole, updated by
    :func:`_update`, and the local shards written back."""
    from torch.distributed.tensor import distribute_tensor

    if not isinstance(m, Mapping):
        return _update(p, g, m, v, *args, placed=True)

    def whole(x):
        return {k: whole(x[k]) for k in x} if isinstance(x, Mapping) else (
            x.full_tensor())

    def local(x, like):
        if isinstance(like, Mapping):
            return {k: local(x[k], like[k]) for k in like}
        return distribute_tensor(x, like.device_mesh, like.placements,
                                 src_data_rank=None)

    pf = p.full_tensor()
    new_m, new_v = _update(pf, None if g is None else g.full_tensor(),
                           whole(m), whole(v),
                           *(a.full_tensor() if hasattr(a, "full_tensor")
                             else a for a in args))
    p.copy_(local(pf, p))
    return local(new_m, m), local(new_v, v)


def _update(p: Tensor, g: Tensor | None, m, v, wd: float, clip: Tensor,
            lr: Tensor, b1c: Tensor, b2c: Tensor, cfg: OptConfig, *,
            placed: bool = False):
    """One parameter's AdamW update, ``p`` in place; returns its new
    moments. The arithmetic is the reference's, operation by operation
    (products and sums in its order, each rounded once), with temporaries
    freed as soon as they are spent and in-place operations where they
    round alike: at most about five float32 copies of the parameter are
    alive at once, and none outlives the call. ``placed``: ``p``, ``g``
    and the float32 moments are DTensors (:func:`_update_dtensor`)."""
    gf = (torch.zeros_like(p, dtype=torch.float32)
          if g is None else g.to(torch.float32) * clip)
    if placed:
        gf = _placed_as(gf, m)
    if cfg.quantize_moments:
        m_f = cfg.b1 * _qdecode(m, p.shape)
        m_f += (1 - cfg.b1) * gf
        v_f = cfg.b2 * _qdecode_sqrt(v, p.shape)
        g2 = (1 - cfg.b2) * gf
        g2 *= gf
        v_f += g2
        del g2
    else:
        m_f = m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v_f = v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
    del gf
    den = v_f / b2c
    den.sqrt_()
    den += cfg.eps
    upd = m_f / b1c
    upd /= den
    del den
    if placed:
        upd = _placed_as(upd, p)
    pf = p.to(torch.float32)
    upd += wd * pf
    upd *= lr
    p.copy_(pf - upd)
    del upd, pf
    if not cfg.quantize_moments:
        return m_f, v_f
    new_m = _qencode(m_f)
    del m_f
    return new_m, _qencode_sqrt(v_f)
