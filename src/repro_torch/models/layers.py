"""Layer library of the port: what the ``rwkv`` layer kind needs.

Port of ``src/repro/models/layers.py``: the dense init, the two norms and
the RWKV-6 (Finch) time mix and channel mix. ``init_*`` returns a dict of
tensors as the reference's returns a param dict; the ``*_fwd`` functions
apply a mapping of parameters by name (a dict, an ``nn.ParameterDict`` or
one of the modules below) and return ``(out, new_cache)`` as the
reference's do. :class:`RWKV6TimeMix` and :class:`RWKV6ChannelMix` hold
the parameters as ``nn.Module``s. Parameters are made for serving: they
require gradients only after ``requires_grad_()`` (which
``models.model.init_params(..., requires_grad=True)`` calls). The time
mix runs its recurrence through ``kernels.rwkv_scan.rwkv_scan`` (no
backward) when no gradient is needed, and through
:func:`rwkv_chunked_core`, plain tensor operations that autograd
differentiates, when one is. The attention, MLA, MoE, RG-LRU and Whisper
layers are not ported yet (ROADMAP queue 1 item 2.2).
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

_LOG_DECAY_CLAMP = 5.0   # per-step |log w| cap, as the reference's: keeps
                         # every exponent difference inside a chunk within
                         # float32 range (16 * 5 = 80 < log(f32 max) ~ 88.7)
RWKV_CHUNK = 16          # chunk length of the chunked-parallel core, the
                         # reference's default


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


def rwkv_chunked_core(r: Tensor, k: Tensor, v: Tensor, w: Tensor,
                      u: Tensor, state0: Tensor, chunk: int = RWKV_CHUNK
                      ) -> tuple[Tensor, Tensor]:
    """The reference's chunked-parallel form of the recurrence
    (``_rwkv_chunked_core``), the same math as ``rwkv_scan`` in plain
    tensor operations, so that autograd differentiates it. Within a chunk,
    with A_t = prod_{j<=t} w_j,

        out_t = r_t diag(A_{t-1}) S_0
              + sum_{i<t} r_t diag(A_{t-1}/A_i) k_i^T v_i
              + (r_t . u k_t) v_t.

    S is padded to a multiple of ``chunk`` (r, k, v with 0, w with 1, so
    the state passes the padding unchanged). The intra-chunk and bonus
    terms of all chunks are batched einsums; only the carried state is a
    loop over the chunks, each chunk's increment computed for all chunks
    at once. r/k/v/w [B, S, H, hd] float32, u [H, hd], state0
    [B, H, hd, hd] -> (out [B, S, H, hd], state_T)."""
    b, s, h, hd = r.shape
    pad = (-s) % chunk
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        w = F.pad(w, z, value=1.0)
    n_c = (s + pad) // chunk

    def resh(t):                                     # [N, B, C, H, hd]
        return t.reshape(b, n_c, chunk, h, hd).transpose(0, 1)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    lw = torch.log(torch.clamp(wc, min=1e-38))       # <= 0
    la = torch.cumsum(lw, dim=2)                     # inclusive
    la_ex = la - lw                                  # exclusive
    la_c = la[:, :, -1:]                             # the chunk's total decay
    mask = (torch.arange(chunk, device=r.device)[:, None]
            > torch.arange(chunk, device=r.device)[None, :])

    rr = rc * torch.exp(la_ex)                       # <= |r|, safe
    kk_neg = kc * torch.exp(-la)                     # bounded by the clamp
    # intra-chunk (strictly causal)
    scores = torch.einsum("nbthk,nbihk->nbhti", rr, kk_neg)
    scores = torch.where(mask, scores, scores.new_zeros(()))
    intra = torch.einsum("nbhti,nbihv->nbthv", scores, vc)
    # diagonal bonus term
    bonus = torch.einsum("nbchk,nbchk->nbch", rc, u * kc)
    # each chunk's state increment and decay, then the carried state
    k_dec = kc * torch.exp(la_c - la)
    incr = torch.einsum("nbihk,nbihv->nbhkv", k_dec, vc)
    decay = torch.exp(la_c[:, :, 0])[..., None]      # [N, B, H, hd, 1]
    states, state = [], state0
    for n in range(n_c):
        states.append(state)
        state = state * decay[n] + incr[n]
    # inter-chunk: the decayed state at the chunk's start
    out = torch.einsum("nbchk,nbhkv->nbchv", rr, torch.stack(states))
    out = out + intra + bonus[..., None] * vc
    out = out.transpose(0, 1).reshape(b, s + pad, h, hd)
    return out[:, :s], state


def _needs_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rwkv6_timemix_fwd(p: Mapping[str, Any], x: Tensor, cfg, *,
                      cache: Cache | None = None
                      ) -> tuple[Tensor, Cache | None]:
    """RWKV-6 time mix. State S [B, H, hd, hd]; recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ; out_t = r_t (S_{t-1} + u k_t^T v_t).

    Where autograd needs a gradient of the recurrence's inputs (training),
    it runs :func:`rwkv_chunked_core`; otherwise (prefill and decode in
    serving) :func:`kernels.rwkv_scan.rwkv_scan`, which has no backward.
    The reference takes its chunked core for every S > 1, prefill
    included, and its sequential scan for S = 1; the two cores are the
    same math, held together by ``tests/test_torch_models.py``
    (``test_forward_logits_matches_reference`` against both of the
    reference's cores) and ``tests/test_torch_train.py``."""
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

    u = p["u"]
    if _needs_grad(r, k, v, w, u, state0):
        out, state_last = rwkv_chunked_core(
            r.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
            w.to(torch.float32), u, state0)
    else:
        out, state_last = rwkv_scan(r, k, v, w, u, state0)
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
