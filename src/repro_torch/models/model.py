"""Model assembly of the port: config -> module / forward / decode step.

Port of ``src/repro/models/model.py`` for every layer kind of the
reference: ``rwkv``, ``rglru`` (Griffin's RG-LRU block between RMSNorms,
with a SwiGLU MLP) and the attention kinds (``attn``, ``attn_dense``,
``local_attn``: GQA with rotary or M-RoPE positions, or Multi-head Latent
Attention where ``cfg.mla`` is set, and a SwiGLU MLP, or a GELU MLP and
LayerNorms in the audio family),
with the MoE feed-forward in the ``attn`` layers of a config with
``cfg.moe`` (:func:`_layer_uses_moe`: DeepSeek's ``attn_dense`` prefix
keeps its SwiGLU), DeepSeek-V3's multi-token head (``cfg.mtp``: an
``mtp`` module of ``proj``, an ``attn_dense`` ``block`` and a ``norm``,
trained by ``train_forward``'s extra term and unused in serving, as in
the reference) and the vision stub (``cfg.frontend == "vision_stub"``:
the first ``n_vision_tokens`` embeddings replaced by precomputed patch
embeddings). The reference stacks each period's parameters on a leading
axis and runs the layers as a ``lax.scan``; the port keeps one module per
layer (:class:`LM` holds an ``nn.ModuleList`` of :class:`Block`) and runs
them in a plain loop. Training (``train_forward``) recomputes each layer
of the scanned periods in the backward pass (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` of the period body) and computes the
cross-entropy in sequence chunks (``chunked_ce_loss``). Decode caches are
a list with one entry per layer; an attention layer's ``length`` is a
host int. An M-RoPE model rotates by ``pos3`` [B, S, 3] (temporal,
height, width), which the caller passes (the batch's ``pos3``, or
``decode_step``'s ``pos``); where none is given the port raises
``ValueError`` (:func:`positions`), as the reference fails there too.

The Whisper encoder-decoder (``cfg.enc_dec``): :class:`LM` also holds
``enc`` (:class:`Encoder`), learned decoder positions ``dec_pos`` and one
``cross`` attention per decoder layer (:class:`CrossAttention`);
``train_forward`` runs :func:`encoder_fwd` over the batch's
``enc_input`` and the decoder through :func:`_dec_layers_with_cross`,
whose ``self_caches`` and ``cross_kv`` arguments are the reference's
decode pieces. The reference's ``forward_logits``, ``decode_step`` and
serving steps run such a model's decoder self-attention alone (no
``dec_pos``, no cross-attention, no encoder); the port raises
``ValueError`` there instead (:func:`_decoder_only`).

Every forward, step and layer takes ``shard`` (``NO_SHARD`` by default;
``sharding.rules.make_shard_fn``), handed down to the layers as in the
reference: the embedding output (``act_resid``) in ``train_forward`` and
``decode_step``, each chunk's logits (``logits``) in
``chunked_ce_loss``, the decode step's logits.
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
NO_SHARD = L.NO_SHARD
ATTN_KINDS = ("attn", "attn_dense", "local_attn")
_ENC_DEC = ("{} of {}: an encoder-decoder model is served by its pieces, "
            "not by {}: encoder_fwd over the encoder input, the cross keys "
            "and values of each layer, then _dec_layers_with_cross(..., "
            "self_caches=..., cross_kv=...) per token. The reference runs "
            "the decoder's self-attention layers alone there (no dec_pos, no "
            "cross-attention, no encoder)")
_NEEDS_POS3 = ("{} rotates by M-RoPE positions: pass pos3 [B, S, 3] "
               "(temporal, height, width; a batch's 'pos3', or decode_step's "
               "pos). The reference fails on this call too: it rotates by "
               "[B, S] positions there")


def _norm(x: Tensor, p, eps: float) -> Tensor:
    """Dispatch RMSNorm vs LayerNorm on param structure."""
    return L.layernorm(x, p, eps) if "bias" in p else L.rmsnorm(x, p, eps)


def _decoder_only(cfg: ArchConfig, what: str) -> None:
    """Raises ValueError if ``cfg`` is an encoder-decoder model, which
    ``what`` (a decoder-only serving path) would run without its encoder
    as the reference's does."""
    if cfg.enc_dec:
        raise ValueError(_ENC_DEC.format(what, cfg.name, what))


# ---------------------------------------------------------------------------
# per-layer init/apply dispatch
# ---------------------------------------------------------------------------

def _init_block_norm(cfg: ArchConfig, dtype, device=None) -> nn.ParameterDict:
    return L.param_dict(L.init_layernorm(cfg.d_model, dtype, device)
                        if cfg.family == "audio"
                        else L.init_rmsnorm(cfg.d_model, dtype, device))


def _layer_uses_moe(cfg: ArchConfig, kind: str) -> bool:
    return cfg.moe is not None and kind == "attn"


def _ffn_fwd(p, x: Tensor, cfg: ArchConfig, shard=NO_SHARD) -> Tensor:
    if "router" in p:
        return L.moe_fwd(p, x, cfg, shard)
    if "w1" in p:
        return L.gelu_mlp_fwd(p, x, shard)
    return L.swiglu_fwd(p, x, shard)


class Block(nn.Module):
    """One layer under the names of the reference's per-layer param tree:
    ``ln1``, ``mixer``, ``ln2``, ``ffn``. An ``rwkv`` layer: LayerNorms,
    the time mix and the channel mix. An ``rglru`` layer: RMSNorms,
    :class:`layers.RGLRU` and a SwiGLU MLP. An attention layer: the block norms
    (:func:`_init_block_norm`), :class:`layers.Attention` (or
    :class:`layers.MLA` where ``cfg.mla`` is set) and a SwiGLU MLP (a GELU
    MLP in the audio family; :class:`layers.MoE` in an ``attn`` layer of a
    config with ``cfg.moe``)."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, *, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        if kind == "rwkv":
            self.ln1 = L.param_dict(L.init_layernorm(d, dtype, device))
            self.mixer = L.RWKV6TimeMix(cfg, dtype, generator=generator,
                                        device=device)
            self.ln2 = L.param_dict(L.init_layernorm(d, dtype, device))
            self.ffn = L.RWKV6ChannelMix(cfg, dtype, generator=generator,
                                         device=device)
        elif kind == "rglru":
            self.ln1 = L.param_dict(L.init_rmsnorm(d, dtype, device))
            self.mixer = L.RGLRU(cfg, dtype, generator=generator,
                                 device=device)
            self.ln2 = L.param_dict(L.init_rmsnorm(d, dtype, device))
            self.ffn = L.SwiGLU(d, cfg.d_ff, dtype, generator=generator,
                                device=device)
        elif kind in ATTN_KINDS:
            self.ln1 = _init_block_norm(cfg, dtype, device)
            self.ln2 = _init_block_norm(cfg, dtype, device)
            mixer = L.MLA if cfg.mla is not None else L.Attention
            self.mixer = mixer(cfg, dtype, generator=generator,
                               device=device)
            if _layer_uses_moe(cfg, kind):
                self.ffn = L.MoE(cfg, dtype, generator=generator,
                                 device=device)
            else:
                mlp = L.GeluMLP if cfg.family == "audio" else L.SwiGLU
                self.ffn = mlp(d, cfg.d_ff, dtype, generator=generator,
                               device=device)
        else:
            raise ValueError(f"unknown layer kind {kind}")


def apply_layer(p: Block, x: Tensor, cfg: ArchConfig, kind: str, *,
                pos: Tensor | None = None, cache=None, shard=NO_SHARD
                ) -> tuple[Tensor, dict | None]:
    """One layer; ``pos`` are the positions an attention layer rotates by,
    [B, S] (or [B, S, 3] for M-RoPE; the recurrent kinds take none);
    ``shard`` constrains activations (``layers.NO_SHARD``)."""
    if kind in ATTN_KINDS:
        h = _norm(x, p.ln1, cfg.norm_eps)
        window = cfg.local_window if kind == "local_attn" else None
        if cfg.mla is not None:
            a, new_cache = L.mla_fwd(p.mixer, h, cfg, pos=pos, cache=cache,
                                     shard=shard)
        else:
            a, new_cache = L.attention_fwd(p.mixer, h, cfg, pos=pos,
                                           cache=cache, causal=True,
                                           window=window, shard=shard)
        x = x + a
        h = _norm(x, p.ln2, cfg.norm_eps)
        return x + _ffn_fwd(p.ffn, h, cfg, shard), new_cache
    if kind == "rglru":
        h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
        a, new_cache = L.rglru_block_fwd(p.mixer, h, cfg, cache=cache,
                                         shard=shard)
        x = x + a
        h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
        return x + L.swiglu_fwd(p.ffn, h, shard), new_cache
    if kind != "rwkv":
        raise ValueError(f"unknown layer kind {kind}")
    h = L.layernorm(x, p.ln1, cfg.norm_eps)
    a, c1 = L.rwkv6_timemix_fwd(p.mixer, h, cfg, cache=(
        cache["tm"] if cache is not None else None), shard=shard)
    x = x + a
    h = L.layernorm(x, p.ln2, cfg.norm_eps)
    f, c2 = L.rwkv6_channelmix_fwd(p.ffn, h, cfg, cache=(
        cache["cm"] if cache is not None else None), shard=shard)
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

class MTP(nn.Module):
    """DeepSeek-V3's multi-token head under the reference's names:
    ``proj`` [2d, d], ``block`` (an ``attn_dense`` :class:`Block`) and
    ``norm`` (an RMSNorm)."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.proj = nn.Parameter(L._dense_init(
            generator, (2 * d, d), None, dtype, device), requires_grad=False)
        self.block = Block(cfg, "attn_dense", dtype, generator=generator,
                           device=device)
        self.norm = L.param_dict(L.init_rmsnorm(d, dtype, device))


class EncoderLayer(nn.Module):
    """One Whisper encoder layer under the reference's names: ``ln1``
    (LayerNorm), ``attn`` (:class:`layers.Attention`), ``ln2``
    (LayerNorm), ``mlp`` (:class:`layers.GeluMLP`)."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = L.param_dict(L.init_layernorm(d, dtype, device))
        self.attn = L.Attention(cfg, dtype, generator=generator,
                                device=device)
        self.ln2 = L.param_dict(L.init_layernorm(d, dtype, device))
        self.mlp = L.GeluMLP(d, cfg.d_ff, dtype, generator=generator,
                             device=device)


class Encoder(nn.Module):
    """The Whisper encoder over precomputed (stub) frame embeddings:
    ``pos`` [enc_context, d], ``layers`` (``n_enc_layers`` of
    :class:`EncoderLayer`) and ``ln_post`` (LayerNorm)."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.pos = nn.Parameter(L._dense_init(
            generator, (cfg.enc_context, d), 0.02, dtype, device),
            requires_grad=False)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, generator=generator, device=device)
            for _ in range(cfg.n_enc_layers))
        self.ln_post = L.param_dict(L.init_layernorm(d, dtype, device))


class CrossAttention(nn.Module):
    """A decoder layer's cross-attention: ``ln`` (an RMSNorm) and ``attn``
    (:class:`layers.Attention`; its bias-free ``wq`` applies to the
    decoder, ``wk`` and ``wv`` to the encoder's output)."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None,
                 device=None):
        super().__init__()
        self.ln = L.param_dict(L.init_rmsnorm(cfg.d_model, dtype, device))
        self.attn = L.Attention(cfg, dtype, generator=generator,
                                device=device)


class LM(nn.Module):
    """The language model: ``embed`` [V, d], ``blocks`` (one per layer, in
    ``cfg.layer_kinds`` order), ``final_norm``, unless the config ties
    them ``unembed`` [d, V], with ``cfg.mtp`` the multi-token head
    ``mtp`` (:class:`MTP`), and with ``cfg.enc_dec`` the encoder ``enc``
    (:class:`Encoder`), the learned decoder positions ``dec_pos``
    [max_target_len, d] and ``cross``, one :class:`CrossAttention` per
    decoder layer. Its parameters are made without gradients (serving);
    ``requires_grad_()`` makes them trainable."""

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
            Block(cfg, kind, dtype, generator=generator, device=device)
            for kind in cfg.layer_kinds)
        if cfg.mtp:
            self.mtp = MTP(cfg, dtype, generator=generator, device=device)
        if cfg.enc_dec:
            self.enc = Encoder(cfg, dtype, generator=generator,
                               device=device)
            self.dec_pos = nn.Parameter(L._dense_init(
                generator, (cfg.max_target_len, d), 0.02, dtype, device),
                requires_grad=False)
            self.cross = nn.ModuleList(
                CrossAttention(cfg, dtype, generator=generator,
                               device=device)
                for _ in range(cfg.n_layers))

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

def positions(cfg: ArchConfig, b: int, s: int, device,
              offset: int = 0) -> Tensor | None:
    """The positions [B, S] (``offset`` .. ``offset + S - 1`` in every row)
    that the layers rotate by for ``cfg.pos == "rope"``; None for a model
    whose attention does not rotate (``"none"``: the ``rwkv`` kind;
    ``"learned"``: Whisper's added ``dec_pos``). An M-RoPE model's
    positions are the caller's ``pos3`` [B, S, 3]: ValueError."""
    if cfg.pos in ("none", "learned"):
        return None
    if cfg.pos == "mrope":
        raise ValueError(_NEEDS_POS3.format(cfg.name))
    if cfg.pos != "rope":
        raise ValueError(f"unknown position kind {cfg.pos!r}")
    return (torch.arange(s, device=device) + offset).expand(b, s)


def _run_layers(params: LM, x: Tensor, cfg: ArchConfig, *,
                pos: Tensor | None = None, shard=NO_SHARD,
                remat: bool = False) -> Tensor:
    """The blocks in order, attention layers rotating by ``pos``. With
    ``remat`` (and autograd recording), each layer of the scanned periods
    keeps only its input for the backward pass and runs again there, as
    the reference's ``jax.checkpoint`` of its period body; prefix and tail
    layers are not recomputed, as there."""
    scanned = _scanned_layers(cfg)
    remat = remat and torch.is_grad_enabled()
    for i, (blk, kind) in enumerate(zip(params.blocks, cfg.layer_kinds)):
        if remat and i in scanned:
            # the forward draws no random numbers: no RNG state to replay
            x = checkpoint(_layer_out, blk, x, cfg, kind, pos, shard,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_out(blk, x, cfg, kind, pos, shard)
    return x


def _layer_out(blk: Block, x: Tensor, cfg: ArchConfig, kind: str,
               pos: Tensor | None, shard=NO_SHARD) -> Tensor:
    return apply_layer(blk, x, cfg, kind, pos=pos, shard=shard)[0]


def _logits(x: Tensor, unembed: Tensor) -> Tensor:
    """``x @ unembed`` accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.to(torch.float32), unembed.to(torch.float32))


def forward_logits(params: LM, tokens: Tensor, cfg: ArchConfig, *,
                   shard=NO_SHARD) -> Tensor:
    """Full-sequence logits [B, S, V] float32 of ``tokens`` [B, S], at
    positions 0 .. S-1 (ValueError on an M-RoPE model, which needs
    ``pos3``: :func:`positions`; and on an encoder-decoder model:
    :func:`_decoder_only`)."""
    _decoder_only(cfg, "forward_logits")
    b, s = tokens.shape
    x = params.embed[tokens]
    x = _run_layers(params, x, cfg, pos=positions(cfg, b, s, tokens.device),
                    shard=shard)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return _logits(x, params.unembedding())


def chunked_ce_loss(x: Tensor, unembed: Tensor, labels: Tensor,
                    mask: Tensor, *, chunk: int = 512,
                    shard=NO_SHARD) -> Tensor:
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
        logits = shard(_logits(xc[:, i], unembed), "logits")
        lse = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp(lc[:, i], min=0).to(torch.int64)
        gold = torch.gather(L.unshard_dim(logits, -1), -1,
                            safe[..., None])[..., 0]
        mm = mc[:, i].to(torch.float32)
        nlls.append(torch.sum((lse - gold) * mm))
        cnts.append(torch.sum(mm))
    return torch.sum(torch.stack(nlls)) / torch.clamp(
        torch.sum(torch.stack(cnts)), min=1.0)


def train_forward(params: LM, batch: dict[str, Tensor], cfg: ArchConfig,
                  *, shard=NO_SHARD, remat: bool = True) -> Tensor:
    """Training loss of one (micro)batch: ``tokens``, ``labels`` and
    ``mask`` [B, S] -> the mean next-token cross-entropy, a 0-d float32
    tensor on the batch's device. Attention layers rotate by positions
    0 .. S-1 (the ``rwkv`` kind takes none), or, with M-RoPE or the vision
    stub, by the batch's ``pos3`` [B, S, 3]. With the vision stub the
    first ``n_vision_tokens`` embeddings are replaced by the batch's
    ``vision_embeds`` (cast to the embedding's dtype), as the reference
    does (``x[:, n_vision_tokens:]`` follows them, so a sequence of at
    most ``n_vision_tokens`` is the vision embeddings alone). With
    ``cfg.mtp`` the multi-token head's loss is added at weight 0.1
    (:func:`_mtp_loss`). The MoE's auxiliary loss is not added, as in the
    reference. An encoder-decoder model (``cfg.enc_dec``) runs
    :func:`encoder_fwd` over the batch's ``enc_input``, adds ``dec_pos``
    to the embeddings and runs the decoder with cross-attention
    (:func:`_dec_layers_with_cross`), then its final LayerNorm; with
    ``remat`` each encoder and decoder layer is recomputed in the backward
    pass."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = shard(F.embedding(tokens, L.unshard_dim(params.embed, 0)),
              "act_resid")
    if cfg.enc_dec:
        memory = encoder_fwd(params, batch["enc_input"], cfg, shard,
                             remat=remat)
        x = x + params.dec_pos[None, :s]
        x, _ = _dec_layers_with_cross(
            params, x, memory, cfg, pos=positions(cfg, b, s, tokens.device),
            shard=shard, remat=remat)
        x = L.layernorm(x, params.final_norm, cfg.norm_eps)
        return chunked_ce_loss(x, params.unembedding(), batch["labels"],
                               batch["mask"], shard=shard)
    if cfg.frontend == "vision_stub":
        nv = cfg.n_vision_tokens
        if nv:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x[:, nv:]],
                          dim=1)
        pos = batch["pos3"]
    elif cfg.pos == "mrope":
        pos = batch["pos3"]
    else:
        pos = positions(cfg, b, s, tokens.device)
    x = _run_layers(params, x, cfg, pos=pos, shard=shard, remat=remat)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    unembed = params.unembedding()
    loss = chunked_ce_loss(x, unembed, batch["labels"], batch["mask"],
                           shard=shard)
    if cfg.mtp:
        loss = loss + 0.1 * _mtp_loss(params, x, batch, cfg, pos, unembed,
                                      shard)
    return loss


def encoder_fwd(params: LM, enc_in: Tensor, cfg: ArchConfig,
                shard=NO_SHARD, remat: bool = False) -> Tensor:
    """Whisper encoder: precomputed conv-stub embeddings ``enc_in`` [B,
    S_enc, d] -> memory [B, S_enc, d]. ``enc.pos[:S_enc]`` is added, then
    each layer: LayerNorm, non-causal self-attention (unrotated),
    residual, LayerNorm, GELU MLP, residual; ``ln_post`` at the end. With
    ``remat`` (and autograd recording) each layer runs again in the
    backward pass."""
    e = params.enc
    x = enc_in + e.pos[None, :enc_in.shape[1]]
    remat = remat and torch.is_grad_enabled()
    for lp in e.layers:
        if remat:
            x = checkpoint(_enc_layer, lp, x, cfg, shard,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_layer(lp, x, cfg, shard)
    return L.layernorm(x, e.ln_post, cfg.norm_eps)


def _enc_layer(lp: EncoderLayer, x: Tensor, cfg: ArchConfig,
               shard=NO_SHARD) -> Tensor:
    h = L.layernorm(x, lp.ln1, cfg.norm_eps)
    # learned positions: the attention rotates by none
    a, _ = L.attention_fwd(lp.attn, h, cfg, pos=None, causal=False,
                           shard=shard)
    x = x + a
    h = L.layernorm(x, lp.ln2, cfg.norm_eps)
    return x + L.gelu_mlp_fwd(lp.mlp, h, shard)


def _cross_kv(attn: L.Attention, memory: Tensor, cfg: ArchConfig
              ) -> tuple[Tensor, Tensor]:
    """A cross-attention's keys and values [B, S_enc, Hk, hd] of the
    encoder's output: ``memory @ wk``, ``memory @ wv`` (no bias)."""
    b, s, d = memory.shape
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    k = L.reshape(memory @ L.reshape(attn.wk, d, hk * hd), b, s, hk, hd)
    v = L.reshape(memory @ L.reshape(attn.wv, d, hk * hd), b, s, hk, hd)
    return k, v


def _dec_layers_with_cross(params: LM, x: Tensor, memory: Tensor | None,
                           cfg: ArchConfig, *, pos: Tensor | None,
                           self_caches: Cache | None = None,
                           cross_kv: list | None = None,
                           shard=NO_SHARD, remat: bool = False
                           ) -> tuple[Tensor, list]:
    """Whisper decoder: per layer self-attention (causal, from
    ``self_caches[i]`` if given), cross-attention and MLP; returns (x,
    the new self-attention caches, None each without caches). The block
    norms are the config's (LayerNorms in the audio family), the cross
    norm an RMSNorm. The cross-attention is non-causal and unrotated, its
    keys and values ``cross_kv[i]`` (``(k, v)`` [B, S_enc, Hk, hd]) or,
    without them, :func:`_cross_kv` of ``memory``. With ``remat`` (and
    autograd recording) each layer runs again in the backward pass. Every
    layer is an attention layer here, as in the reference (which runs none
    with a window)."""
    remat = remat and torch.is_grad_enabled()
    new_self = []
    for li, (blk, cp) in enumerate(zip(params.blocks, params.cross)):
        cache_i = None if self_caches is None else self_caches[li]
        ckv = None if cross_kv is None else cross_kv[li]
        if remat:
            x, nc = checkpoint(_dec_layer, blk, cp, x, memory, cfg, pos,
                               cache_i, ckv, shard, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, nc = _dec_layer(blk, cp, x, memory, cfg, pos, cache_i, ckv,
                               shard)
        new_self.append(nc)
    return x, new_self


def _dec_layer(blk: Block, cp: CrossAttention, x: Tensor,
               memory: Tensor | None, cfg: ArchConfig, pos: Tensor | None,
               cache, ckv, shard=NO_SHARD) -> tuple[Tensor, dict | None]:
    h = _norm(x, blk.ln1, cfg.norm_eps)
    a, nc = L.attention_fwd(blk.mixer, h, cfg, pos=pos, cache=cache,
                            causal=True, shard=shard)
    x = x + a
    h = L.rmsnorm(x, cp.ln, cfg.norm_eps)
    b, s, d = h.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q = L.reshape(h @ L.reshape(cp.attn.wq, d, hq * hd), b, s, hq, hd)
    ck, cv = ckv if ckv is not None else _cross_kv(cp.attn, memory, cfg)
    o = L._sdpa(q, ck, cv, causal=False, window=None, shard=shard)
    x = x + L.reshape(o, b, s, hq * hd) @ L.reshape(cp.attn.wo, hq * hd, d)
    h = _norm(x, blk.ln2, cfg.norm_eps)
    return x + _ffn_fwd(blk.ffn, h, cfg, shard), nc


def _mtp_loss(params: LM, x: Tensor, batch: dict[str, Tensor],
              cfg: ArchConfig, pos: Tensor | None, unembed: Tensor,
              shard=NO_SHARD) -> Tensor:
    """DeepSeek-V3's multi-token prediction: from the final-normed ``x``
    [B, S, d] concatenated with the embedding of token t+1 (zero at the
    last position), ``mtp.proj``, the ``attn_dense`` block at the same
    positions (not recomputed in the backward pass, as in the reference)
    and ``mtp.norm`` predict token t+2: the chunked cross-entropy against
    the labels and mask shifted by one (zero at the end)."""
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    emb_next = torch.cat([F.embedding(tokens[:, 1:],
                                      L.unshard_dim(params.embed, 0)),
                          x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    h = L.pin(shard, torch.cat([x, emb_next.to(x.dtype)], dim=-1)
              @ params.mtp.proj, "act_resid")
    h, _ = apply_layer(params.mtp.block, h, cfg, "attn_dense", pos=pos,
                       shard=shard)
    h = L.rmsnorm(h, params.mtp.norm, cfg.norm_eps)
    labels2 = torch.cat([labels[:, 1:], labels.new_zeros(
        (labels.shape[0], 1))], dim=1)
    mask2 = torch.cat([mask[:, 1:], mask.new_zeros((mask.shape[0], 1))],
                      dim=1)
    return chunked_ce_loss(h, unembed, labels2, mask2, shard=shard)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """One cache per layer. An ``rwkv`` layer: the time mix's last token
    (``dtype``) and [B, H, hd, hd] float32 state, the channel mix's last
    token. An attention layer: ``k`` and ``v`` [B, S_max, Hk, hd]
    (``dtype``) and ``length``, a host int (0), with S_max = ``max_len``;
    a ``local_attn`` layer's is a ring buffer of S_max = min(max_len,
    local_window) slots with ``pos`` [B, S_max] int32, -1 where unwritten;
    an MLA layer's (``cfg.mla``) holds ``latent`` [B, S_max, kv_rank] and
    ``k_rope`` [B, S_max, 1, d_rope] (``dtype``) instead of ``k`` and
    ``v``. An ``rglru`` layer: the state ``h`` [B, d] float32 and the
    conv's last 3 inputs ``conv`` [B, 3, d] (``dtype``). An
    encoder-decoder model's are its decoder layers' self-attention caches,
    which :func:`_dec_layers_with_cross` takes as ``self_caches``."""
    dev = resolve_device(device)
    cache = []
    for kind in cfg.layer_kinds:
        if kind == "rwkv":
            d, hd = cfg.d_model, cfg.rwkv_head_dim
            cache.append({
                "tm": {"x_prev": torch.zeros((batch, d), dtype=dtype,
                                             device=dev),
                       "state": torch.zeros((batch, d // hd, hd, hd),
                                            dtype=torch.float32, device=dev)},
                "cm": {"x_prev": torch.zeros((batch, d), dtype=dtype,
                                             device=dev)}})
        elif kind == "rglru":
            d = cfg.d_model
            cache.append({
                "h": torch.zeros((batch, d), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((batch, 3, d), dtype=dtype,
                                    device=dev)})
        elif kind in ("attn", "attn_dense") and cfg.mla is not None:
            m = cfg.mla
            cache.append({
                "latent": torch.zeros((batch, max_len, m.kv_rank),
                                      dtype=dtype, device=dev),
                "k_rope": torch.zeros((batch, max_len, 1, m.d_rope),
                                      dtype=dtype, device=dev),
                "length": 0})
        elif kind in ATTN_KINDS:
            s_max = (min(max_len, cfg.local_window) if kind == "local_attn"
                     else max_len)
            shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "length": 0}
            if kind == "local_attn":
                c["pos"] = torch.full((batch, s_max), -1, dtype=torch.int32,
                                      device=dev)
            cache.append(c)
        else:
            raise ValueError(f"unknown layer kind {kind}")
    return cache


def _cache_length(cache: Cache, cfg: ArchConfig) -> int:
    """The reference's decode position: the length of the first layer's
    cache if it has one (a prefix layer), else of the first attention
    layer of the scanned period, else 0."""
    groups = layer_groups(cfg)
    lo = len(groups.prefix_kinds)
    if lo and "length" in cache[0]:
        return cache[0]["length"]
    if groups.n_periods:
        for si, kind in enumerate(groups.period):
            if kind in ATTN_KINDS:
                return cache[lo + si]["length"]
    return 0


def decode_step(params: LM, cache: Cache, tokens: Tensor, cfg: ArchConfig,
                *, pos: Tensor | None = None, shard=NO_SHARD
                ) -> tuple[Tensor, Cache]:
    """Tokens [B, S] (one token, or a whole prompt for a cache-writing
    prefill) -> (logits [B, S, V] float32, new cache). ``pos`` are the
    tokens' positions for the rotary embedding, [B, S] (or [B, S, 3] for an
    M-RoPE model, which must be given them: ValueError otherwise); by
    default (as in the reference) every token takes the cache's length
    (:func:`_cache_length`). That is the right position for one token; for
    S > 1 the reference rotates every token of the prompt alike while its
    causal mask places them at length + i, so with rope attention layers
    (MLA's included) the port asks for ``pos`` instead (ValueError). An
    encoder-decoder model raises ValueError (:func:`_decoder_only`)."""
    _decoder_only(cfg, "decode_step")
    b, s = tokens.shape
    if pos is None and cfg.pos != "none":
        if (cfg.pos == "rope" and s > 1
                and any(k in ATTN_KINDS for k in cfg.layer_kinds)):
            raise ValueError(
                f"decode_step of {s} tokens: pass pos [B, S] (e.g. length + "
                "arange(S)); without it every token would be rotated by the "
                "cache length, as the reference does")
        pos = positions(cfg, b, s, tokens.device,
                        offset=_cache_length(cache, cfg))
    x = shard(L.take_rows(params.embed, tokens), "act_resid")
    new_cache = []
    for blk, kind, c in zip(params.blocks, cfg.layer_kinds, cache):
        x, nc = apply_layer(blk, x, cfg, kind, pos=pos, cache=c, shard=shard)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return shard(_logits(x, params.unembedding()), "logits"), new_cache


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the model, counted on the meta device (nothing is
    allocated). With ``active_only``, less the experts a token does not
    use: (E - top_k) x 3 x d x ff in every MoE layer."""
    model = init_params(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    if not active_only or cfg.moe is None:
        return total
    mo = cfg.moe
    per_expert = 3 * cfg.d_model * (mo.d_expert or cfg.d_ff)
    n_moe_layers = sum(_layer_uses_moe(cfg, k) for k in cfg.layer_kinds)
    return total - n_moe_layers * per_expert * (mo.n_experts - mo.top_k)
