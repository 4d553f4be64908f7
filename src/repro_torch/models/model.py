"""Model assembly of the port: config -> module / forward / decode step.

Port of ``src/repro/models/model.py`` for the ``rwkv`` layer kind. The
reference stacks each period's parameters on a leading axis and runs the
layers as a ``lax.scan``; the port keeps one module per layer
(:class:`LM` holds an ``nn.ModuleList`` of :class:`Block`) and runs them in
a plain loop, with no remat. Decode caches are a list with one entry per
layer. The attention, MLA, MoE, RG-LRU and Whisper kinds, the chunked
training loss and ``train_forward`` are not ported yet (ROADMAP queue 1
item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..core.api import resolve_device
from . import layers as L
from .config import ArchConfig

Tensor = torch.Tensor
Cache = list[dict[str, Any]]
_NOT_PORTED = ("layer kind {!r} is not ported yet (ROADMAP queue 1 item 14: "
               "only the rwkv kind has landed)")


def _norm(x: Tensor, p, eps: float) -> Tensor:
    """Dispatch RMSNorm vs LayerNorm on param structure."""
    return L.layernorm(x, p, eps) if "bias" in p else L.rmsnorm(x, p, eps)


# ---------------------------------------------------------------------------
# per-layer init/apply dispatch
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One ``rwkv`` layer: ln1, time mix (``mixer``), ln2, channel mix
    (``ffn``), the names of the reference's per-layer param tree."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = L.param_dict(L.init_layernorm(d, dtype, device))
        self.mixer = L.RWKV6TimeMix(cfg, dtype, generator=generator,
                                    device=device)
        self.ln2 = L.param_dict(L.init_layernorm(d, dtype, device))
        self.ffn = L.RWKV6ChannelMix(cfg, dtype, generator=generator,
                                     device=device)


def init_layer(gen, cfg: ArchConfig, kind: str, dtype, device=None) -> Block:
    if kind == "rwkv":
        return Block(cfg, dtype, generator=gen, device=device)
    raise NotImplementedError(_NOT_PORTED.format(kind))


def apply_layer(p: Block, x: Tensor, cfg: ArchConfig, kind: str, *,
                cache=None) -> tuple[Tensor, dict | None]:
    if kind != "rwkv":
        raise NotImplementedError(_NOT_PORTED.format(kind))
    h = L.layernorm(x, p.ln1, cfg.norm_eps)
    a, c1 = L.rwkv6_timemix_fwd(p.mixer, h, cfg, cache=(
        cache["tm"] if cache is not None else None))
    x = x + a
    h = L.layernorm(x, p.ln2, cfg.norm_eps)
    f, c2 = L.rwkv6_channelmix_fwd(p.ffn, h, cfg, cache=(
        cache["cm"] if cache is not None else None))
    new_cache = None if cache is None else {"tm": c1, "cm": c2}
    return x + f, new_cache


# ---------------------------------------------------------------------------
# layer grouping (the reference's scan periods; the port unrolls them)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerGroups:
    prefix_kinds: tuple[str, ...]   # unrolled dense prefix (DeepSeek)
    period: tuple[str, ...]         # scanned pattern
    n_periods: int
    tail_kinds: tuple[str, ...]     # unrolled remainder


def layer_groups(cfg: ArchConfig) -> LayerGroups:
    kinds = list(cfg.layer_kinds)
    prefix = tuple(kinds[: cfg.dense_prefix])
    rest = kinds[cfg.dense_prefix:]
    period = tuple(cfg.layer_pattern)
    n_periods = len(rest) // len(period)
    tail = tuple(rest[n_periods * len(period):])
    return LayerGroups(prefix, period, n_periods, tail)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The language model: ``embed`` [V, d], ``blocks`` (one per layer, in
    ``cfg.layer_kinds`` order), ``final_norm`` and, unless the config ties
    them, ``unembed`` [d, V]."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, *,
                 generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.embed = nn.Parameter(L._dense_init(
            generator, (cfg.vocab, d), 0.02, dtype, device),
            requires_grad=False)
        self.final_norm = L.param_dict(
            L.init_layernorm(d, dtype, device)
            if cfg.family == "audio" or cfg.layer_pattern == ("rwkv",)
            else L.init_rmsnorm(d, dtype, device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(L._dense_init(
                generator, (d, cfg.vocab), 0.02, dtype, device),
                requires_grad=False)
        self.blocks = nn.ModuleList(
            init_layer(generator, cfg, kind, dtype, device)
            for kind in cfg.layer_kinds)

    def unembedding(self) -> Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, *,
                device="cuda") -> LM:
    """The model with random weights drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (the reference draws from a JAX key, so
    the two give different weights from one seed). Raises without a card
    unless ``device`` is ``"cpu"`` (or ``"meta"``, which only allocates
    shapes)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return LM(cfg, dtype, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_layers(params: LM, x: Tensor, cfg: ArchConfig) -> Tensor:
    for blk, kind in zip(params.blocks, cfg.layer_kinds):
        x, _ = apply_layer(blk, x, cfg, kind)
    return x


def _logits(x: Tensor, unembed: Tensor) -> Tensor:
    """``x @ unembed`` accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.to(torch.float32), unembed.to(torch.float32))


def forward_logits(params: LM, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    """Full-sequence logits [B, S, V] float32 of ``tokens`` [B, S]."""
    x = params.embed[tokens]
    x = _run_layers(params, x, cfg)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return _logits(x, params.unembedding())


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """One cache per layer: the time mix's last token (``dtype``) and
    [B, H, hd, hd] float32 state, the channel mix's last token. The
    recurrent state does not grow with the sequence, so ``max_len`` (the
    attention kinds' cache length) sizes nothing here."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    cache = []
    for kind in cfg.layer_kinds:
        if kind != "rwkv":
            raise NotImplementedError(_NOT_PORTED.format(kind))
        cache.append({
            "tm": {"x_prev": torch.zeros((batch, d), dtype=dtype, device=dev),
                   "state": torch.zeros((batch, d // hd, hd, hd),
                                        dtype=torch.float32, device=dev)},
            "cm": {"x_prev": torch.zeros((batch, d), dtype=dtype,
                                         device=dev)}})
    return cache


def decode_step(params: LM, cache: Cache, tokens: Tensor,
                cfg: ArchConfig) -> tuple[Tensor, Cache]:
    """Tokens [B, S] (one token, or a whole prompt for a cache-writing
    prefill) -> (logits [B, S, V] float32, new cache)."""
    x = params.embed[tokens]
    new_cache = []
    for blk, kind, c in zip(params.blocks, cfg.layer_kinds, cache):
        x, nc = apply_layer(blk, x, cfg, kind, cache=c)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return _logits(x, params.unembedding()), new_cache


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

def count_params(cfg: ArchConfig) -> int:
    """Parameters of the model, counted on the meta device (nothing is
    allocated)."""
    model = init_params(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
