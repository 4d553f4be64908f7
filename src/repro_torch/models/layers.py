"""Layer library of the port: what the ``rwkv`` layer kind needs.

Port of ``src/repro/models/layers.py``: the dense init, the two norms and
the RWKV-6 (Finch) time mix and channel mix. ``init_*`` returns a dict of
tensors as the reference's returns a param dict; the ``*_fwd`` functions
apply a mapping of parameters by name (a dict, an ``nn.ParameterDict`` or
one of the modules below) and return ``(out, new_cache)`` as the
reference's do. :class:`RWKV6TimeMix` and :class:`RWKV6ChannelMix` hold
the parameters as ``nn.Module``s. Parameters are made for serving: they
do not require gradients, and the recurrence runs through
``kernels.rwkv_scan.rwkv_scan`` (no backward). The attention, MLA, MoE,
RG-LRU and Whisper layers are not ported yet (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv_scan import rwkv_scan

Tensor = torch.Tensor
Cache = dict[str, Any]


def _dense_init(gen: torch.Generator | None, shape, scale=None,
                dtype=torch.float32, device=None) -> Tensor:
    """N(0, scale^2) of ``shape`` drawn in float32 from ``gen`` on
    ``device`` (``scale`` defaults to 1/sqrt(fan_in)), cast to ``dtype``.
    On the meta device it only allocates the shape."""
    dev = torch.device(device) if device is not None else (
        gen.device if gen is not None else torch.device("cpu"))
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return out.mul_(scale).to(dtype)


def param_dict(tensors: Mapping[str, Tensor]) -> nn.ParameterDict:
    """``tensors`` as an ``nn.ParameterDict`` of parameters that do not
    require gradients."""
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tensors.items()})


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(x: Tensor, p: Mapping[str, Tensor], eps: float) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(x: Tensor, p: Mapping[str, Tensor], eps: float) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay time-mix + channel-mix
# ---------------------------------------------------------------------------

_LOG_DECAY_CLAMP = 5.0   # per-step |log w| cap, as the reference's


def init_rwkv6(gen, cfg, dtype, device=None) -> dict[str, Any]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    n_h = d // hd
    lora = 64
    f32 = torch.float32
    return {
        "maa": 0.5 * torch.ones((5, d), dtype=f32, device=device),  # r,k,v,w,g
        "w0": torch.full((d,), -6.0, dtype=f32, device=device),     # decay base
        "w1": _dense_init(gen, (d, lora), 0.02, f32, device),
        "w2": _dense_init(gen, (lora, d), 0.02, f32, device),
        "u": torch.zeros((n_h, hd), dtype=f32, device=device),      # bonus
        "wr": _dense_init(gen, (d, d), None, dtype, device),
        "wk": _dense_init(gen, (d, d), None, dtype, device),
        "wv": _dense_init(gen, (d, d), None, dtype, device),
        "wg": _dense_init(gen, (d, d), None, dtype, device),
        "wo": _dense_init(gen, (d, d), None, dtype, device),
        "ln_x": init_layernorm(d, f32, device),                     # group-norm-ish
    }


def _token_shift(x: Tensor, cache: Cache | None) -> Tensor:
    """``x`` shifted one step back along S, the cached last token (or 0)
    in front, minus ``x``."""
    b, _s, d = x.shape
    if cache is None:
        x_prev = x.new_zeros((b, 1, d))
    else:
        x_prev = cache["x_prev"][:, None, :].to(x.dtype)
    return torch.cat([x_prev, x[:, :-1, :]], dim=1) - x


def rwkv6_timemix_fwd(p: Mapping[str, Any], x: Tensor, cfg, *,
                      cache: Cache | None = None
                      ) -> tuple[Tensor, Cache | None]:
    """RWKV-6 time mix. State S [B, H, hd, hd]; recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ; out_t = r_t (S_{t-1} + u k_t^T v_t),
    through :func:`kernels.rwkv_scan.rwkv_scan` for every S (prefill and
    decode alike)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    n_h = d // hd

    if cache is None:
        state0 = torch.zeros((b, n_h, hd, hd), dtype=torch.float32,
                             device=x.device)
    else:
        state0 = cache["state"]
    diff = _token_shift(x, cache)

    def mix(i):
        return x + diff * p["maa"][i].to(x.dtype)

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = (xr @ p["wr"]).reshape(b, s, n_h, hd)
    k = (xk @ p["wk"]).reshape(b, s, n_h, hd)
    v = (xv @ p["wv"]).reshape(b, s, n_h, hd)
    g = F.silu(xg @ p["wg"])
    wf = xw.to(torch.float32)
    w = p["w0"] + torch.tanh(wf @ p["w1"]) @ p["w2"]           # [B,S,d]
    w = torch.exp(-torch.clamp(torch.exp(w), 0.0, _LOG_DECAY_CLAMP))
    w = w.reshape(b, s, n_h, hd)                             # decay in (0,1)

    out, state_last = rwkv_scan(r, k, v, w, p["u"], state0)
    out = out.reshape(b, s, d)
    out = layernorm(out, p["ln_x"], 1e-5).to(x.dtype) * g.to(x.dtype)
    out = out @ p["wo"]
    new_cache = None
    if cache is not None:
        new_cache = {"x_prev": x[:, -1, :].clone(), "state": state_last}
    return out, new_cache


def init_rwkv6_channelmix(gen, cfg, dtype, device=None) -> dict[str, Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    f32 = torch.float32
    return {
        "maa_k": 0.5 * torch.ones((d,), dtype=f32, device=device),
        "maa_r": 0.5 * torch.ones((d,), dtype=f32, device=device),
        "wk": _dense_init(gen, (d, ff), None, dtype, device),
        "wv": _dense_init(gen, (ff, d), None, dtype, device),
        "wr": _dense_init(gen, (d, d), None, dtype, device),
    }


def rwkv6_channelmix_fwd(p: Mapping[str, Any], x: Tensor, cfg, *,
                         cache: Cache | None = None
                         ) -> tuple[Tensor, Cache | None]:
    diff = _token_shift(x, cache)
    xk = x + diff * p["maa_k"].to(x.dtype)
    xr = x + diff * p["maa_r"].to(x.dtype)
    h = torch.square(F.relu(xk @ p["wk"]))
    kv = h @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    new_cache = None if cache is None else {"x_prev": x[:, -1, :].clone()}
    return rr * kv, new_cache


class _Params(nn.Module):
    """A module whose parameters are also read by name (``p["wr"]``), so
    that the functional forwards above take it as they take a dict."""

    def __init__(self, tensors: Mapping[str, Any]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, Mapping):
                setattr(self, name, param_dict(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class RWKV6TimeMix(_Params):
    """The time mix's parameters (:func:`init_rwkv6`); ``forward(x, cache)``
    is :func:`rwkv6_timemix_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_rwkv6(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, cache: Cache | None = None):
        return rwkv6_timemix_fwd(self, x, self.cfg, cache=cache)


class RWKV6ChannelMix(_Params):
    """The channel mix's parameters (:func:`init_rwkv6_channelmix`);
    ``forward(x, cache)`` is :func:`rwkv6_channelmix_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_rwkv6_channelmix(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, cache: Cache | None = None):
        return rwkv6_channelmix_fwd(self, x, self.cfg, cache=cache)
