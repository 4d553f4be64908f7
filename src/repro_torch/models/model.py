"""Model assembly of the port: config -> module / forward / decode step.

Port of ``src/repro/models/model.py`` for the ``rwkv`` layer kind. The
reference stacks each period's parameters on a leading axis and runs the
layers as a ``lax.scan``; the port keeps one module per layer
(:class:`LM` holds an ``nn.ModuleList`` of :class:`Block`) and runs them in
a plain loop. Training (``train_forward``) recomputes each layer of the
scanned periods in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of the period body) and computes the
cross-entropy in sequence chunks (``chunked_ce_loss``). Decode caches are
a list with one entry per layer. The attention, MLA, MoE, RG-LRU and
Whisper kinds are not ported yet (ROADMAP queue 1 item 2.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.api import resolve_device
from . import layers as L
from .config import ArchConfig

Tensor = torch.Tensor
Cache = list[dict[str, Any]]
_NOT_PORTED = ("layer kind {!r} is not ported yet (ROADMAP queue 1 item 2.2: "
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
    them, ``unembed`` [d, V]. Its parameters are made without gradients
    (serving); ``requires_grad_()`` makes them trainable."""

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
                device="cuda", requires_grad: bool = False) -> LM:
    """The model with random weights drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (the reference draws from a JAX key, so
    the two give different weights from one seed); its parameters require
    gradients if ``requires_grad`` (to train it). Raises without a card
    unless ``device`` is ``"cpu"`` (or ``"meta"``, which only allocates
    shapes)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return LM(cfg, dtype, generator=gen, device=dev).requires_grad_(
        requires_grad)


def scanned_params(model: LM) -> set[str]:
    """Names of the parameters that the reference stacks over its scanned
    periods (every block of the ``body``, not the prefix or tail), where
    each has one more (leading) axis than in the port. Its optimizer
    decays a parameter by the number of axes it has there."""
    return {f"blocks.{i}.{name}" for i in _scanned_layers(model.cfg)
            for name, _ in model.blocks[i].named_parameters()}


def _scanned_layers(cfg: ArchConfig) -> range:
    """Indices of the layers in the reference's scanned periods."""
    groups = layer_groups(cfg)
    lo = len(groups.prefix_kinds)
    return range(lo, lo + groups.n_periods * len(groups.period))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_layers(params: LM, x: Tensor, cfg: ArchConfig, *,
                remat: bool = False) -> Tensor:
    """The blocks in order. With ``remat`` (and autograd recording), each
    layer of the scanned periods keeps only its input for the backward
    pass and runs again there, as the reference's ``jax.checkpoint`` of
    its period body; prefix and tail layers are not recomputed, as
    there."""
    scanned = _scanned_layers(cfg)
    remat = remat and torch.is_grad_enabled()
    for i, (blk, kind) in enumerate(zip(params.blocks, cfg.layer_kinds)):
        if remat and i in scanned:
            # the forward draws no random numbers: no RNG state to replay
            x = checkpoint(_layer_out, blk, x, cfg, kind,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_out(blk, x, cfg, kind)
    return x


def _layer_out(blk: Block, x: Tensor, cfg: ArchConfig, kind: str) -> Tensor:
    return apply_layer(blk, x, cfg, kind)[0]


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


def chunked_ce_loss(x: Tensor, unembed: Tensor, labels: Tensor,
                    mask: Tensor, *, chunk: int = 512) -> Tensor:
    """Mean next-token cross-entropy of ``x`` [B, S, d] over ``mask``,
    without the whole [B, S, V] logits at once: the sequence runs in
    ``max(1, S // chunk)`` chunks (S must divide into them, as in the
    reference), each chunk's logits in float32; masked labels may be
    sentinels (clipped at 0). The masked mean divides by at least 1."""
    b, s, d = x.shape
    n_chunk = max(1, s // chunk)
    xc = x.reshape(b, n_chunk, s // n_chunk, d)
    lc = labels.reshape(b, n_chunk, s // n_chunk)
    mc = mask.reshape(b, n_chunk, s // n_chunk)
    nlls, cnts = [], []
    for i in range(n_chunk):
        logits = _logits(xc[:, i], unembed)
        lse = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp(lc[:, i], min=0).to(torch.int64)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        mm = mc[:, i].to(torch.float32)
        nlls.append(torch.sum((lse - gold) * mm))
        cnts.append(torch.sum(mm))
    return torch.sum(torch.stack(nlls)) / torch.clamp(
        torch.sum(torch.stack(cnts)), min=1.0)


def train_forward(params: LM, batch: dict[str, Tensor], cfg: ArchConfig,
                  *, remat: bool = True) -> Tensor:
    """Training loss of one (micro)batch: ``tokens``, ``labels`` and
    ``mask`` [B, S] -> the mean next-token cross-entropy, a 0-d float32
    tensor on the batch's device. The port's layer kind (``rwkv``) takes
    no positions; the vision, M-RoPE, encoder-decoder and multi-token
    parts of the reference's ``train_forward`` come with the layer kinds
    that use them (no config the port can build has them)."""
    x = F.embedding(batch["tokens"], params.embed)
    x = _run_layers(params, x, cfg, remat=remat)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return chunked_ce_loss(x, params.unembedding(), batch["labels"],
                           batch["mask"])


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
