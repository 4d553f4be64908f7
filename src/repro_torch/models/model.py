"""Model assembly of the port: config -> module / forward / decode step.

Port of ``src/repro/models/model.py`` for the ``rwkv`` layer kind and the
attention kinds (``attn``, ``attn_dense``, ``local_attn``: GQA with rotary
or M-RoPE positions, or Multi-head Latent Attention where ``cfg.mla`` is
set, and a SwiGLU MLP, or a GELU MLP and LayerNorms in the audio family),
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
RG-LRU and the Whisper encoder-decoder are not ported yet (ROADMAP queue
1 item 2.2).
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
ATTN_KINDS = ("attn", "attn_dense", "local_attn")
_NOT_PORTED = ("{} is not ported yet (ROADMAP queue 1 item 2.2: the rwkv "
               "and attention kinds, M-RoPE, MLA, MoE and the multi-token "
               "head included, have landed)")
_NEEDS_POS3 = ("{} rotates by M-RoPE positions: pass pos3 [B, S, 3] "
               "(temporal, height, width; a batch's 'pos3', or decode_step's "
               "pos). The reference fails on this call too: it rotates by "
               "[B, S] positions there")


def _norm(x: Tensor, p, eps: float) -> Tensor:
    """Dispatch RMSNorm vs LayerNorm on param structure."""
    return L.layernorm(x, p, eps) if "bias" in p else L.rmsnorm(x, p, eps)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(_NOT_PORTED.format(what))


# ---------------------------------------------------------------------------
# per-layer init/apply dispatch
# ---------------------------------------------------------------------------

def _init_block_norm(cfg: ArchConfig, dtype, device=None) -> nn.ParameterDict:
    return L.param_dict(L.init_layernorm(cfg.d_model, dtype, device)
                        if cfg.family == "audio"
                        else L.init_rmsnorm(cfg.d_model, dtype, device))


def _layer_uses_moe(cfg: ArchConfig, kind: str) -> bool:
    return cfg.moe is not None and kind == "attn"


def _ffn_fwd(p, x: Tensor, cfg: ArchConfig) -> Tensor:
    if "router" in p:
        return L.moe_fwd(p, x, cfg)
    if "w1" in p:
        return L.gelu_mlp_fwd(p, x)
    return L.swiglu_fwd(p, x)


class Block(nn.Module):
    """One layer under the names of the reference's per-layer param tree:
    ``ln1``, ``mixer``, ``ln2``, ``ffn``. An ``rwkv`` layer: LayerNorms,
    the time mix and the channel mix. An attention layer: the block norms
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
            raise _not_ported(f"layer kind {kind!r}")


def apply_layer(p: Block, x: Tensor, cfg: ArchConfig, kind: str, *,
                pos: Tensor | None = None, cache=None
                ) -> tuple[Tensor, dict | None]:
    """One layer; ``pos`` are the positions an attention layer rotates by,
    [B, S] (or [B, S, 3] for M-RoPE; the ``rwkv`` kind takes none)."""
    if kind in ATTN_KINDS:
        h = _norm(x, p.ln1, cfg.norm_eps)
        window = cfg.local_window if kind == "local_attn" else None
        if cfg.mla is not None:
            a, new_cache = L.mla_fwd(p.mixer, h, cfg, pos=pos, cache=cache)
        else:
            a, new_cache = L.attention_fwd(p.mixer, h, cfg, pos=pos,
                                           cache=cache, causal=True,
                                           window=window)
        x = x + a
        h = _norm(x, p.ln2, cfg.norm_eps)
        return x + _ffn_fwd(p.ffn, h, cfg), new_cache
    if kind != "rwkv":
        raise _not_ported(f"layer kind {kind!r}")
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


class LM(nn.Module):
    """The language model: ``embed`` [V, d], ``blocks`` (one per layer, in
    ``cfg.layer_kinds`` order), ``final_norm``, unless the config ties
    them ``unembed`` [d, V], and with ``cfg.mtp`` the multi-token head
    ``mtp`` (:class:`MTP`). Its parameters are made without gradients
    (serving); ``requires_grad_()`` makes them trainable."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, *,
                 generator=None, device=None):
        super().__init__()
        if cfg.enc_dec:
            raise _not_ported("the encoder-decoder")
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
    that takes none (``"none"``: the ``rwkv`` kind). An M-RoPE model's
    positions are the caller's ``pos3`` [B, S, 3]: ValueError."""
    if cfg.pos == "none":
        return None
    if cfg.pos == "mrope":
        raise ValueError(_NEEDS_POS3.format(cfg.name))
    if cfg.pos != "rope":
        raise _not_ported(f"positions of kind {cfg.pos!r}")
    return (torch.arange(s, device=device) + offset).expand(b, s)


def _run_layers(params: LM, x: Tensor, cfg: ArchConfig, *,
                pos: Tensor | None = None, remat: bool = False) -> Tensor:
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
            x = checkpoint(_layer_out, blk, x, cfg, kind, pos,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_out(blk, x, cfg, kind, pos)
    return x


def _layer_out(blk: Block, x: Tensor, cfg: ArchConfig, kind: str,
               pos: Tensor | None) -> Tensor:
    return apply_layer(blk, x, cfg, kind, pos=pos)[0]


def _logits(x: Tensor, unembed: Tensor) -> Tensor:
    """``x @ unembed`` accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.to(torch.float32), unembed.to(torch.float32))


def forward_logits(params: LM, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    """Full-sequence logits [B, S, V] float32 of ``tokens`` [B, S], at
    positions 0 .. S-1 (ValueError on an M-RoPE model, which needs
    ``pos3``: :func:`positions`)."""
    b, s = tokens.shape
    x = params.embed[tokens]
    x = _run_layers(params, x, cfg, pos=positions(cfg, b, s, tokens.device))
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
    tensor on the batch's device. Attention layers rotate by positions
    0 .. S-1 (the ``rwkv`` kind takes none), or, with M-RoPE or the vision
    stub, by the batch's ``pos3`` [B, S, 3]. With the vision stub the
    first ``n_vision_tokens`` embeddings are replaced by the batch's
    ``vision_embeds`` (cast to the embedding's dtype), as the reference
    does (``x[:, n_vision_tokens:]`` follows them, so a sequence of at
    most ``n_vision_tokens`` is the vision embeddings alone). With
    ``cfg.mtp`` the multi-token head's loss is added at weight 0.1
    (:func:`_mtp_loss`). The MoE's auxiliary loss is not added, as in the
    reference. The encoder-decoder part of the reference's
    ``train_forward`` comes with that kind (no config the port can build
    has it)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = F.embedding(tokens, params.embed)
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
    x = _run_layers(params, x, cfg, pos=pos, remat=remat)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    unembed = params.unembedding()
    loss = chunked_ce_loss(x, unembed, batch["labels"], batch["mask"])
    if cfg.mtp:
        loss = loss + 0.1 * _mtp_loss(params, x, batch, cfg, pos, unembed)
    return loss


def _mtp_loss(params: LM, x: Tensor, batch: dict[str, Tensor],
              cfg: ArchConfig, pos: Tensor | None, unembed: Tensor
              ) -> Tensor:
    """DeepSeek-V3's multi-token prediction: from the final-normed ``x``
    [B, S, d] concatenated with the embedding of token t+1 (zero at the
    last position), ``mtp.proj``, the ``attn_dense`` block at the same
    positions (not recomputed in the backward pass, as in the reference)
    and ``mtp.norm`` predict token t+2: the chunked cross-entropy against
    the labels and mask shifted by one (zero at the end)."""
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    emb_next = torch.cat([F.embedding(tokens[:, 1:], params.embed),
                          x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    h = torch.cat([x, emb_next.to(x.dtype)], dim=-1) @ params.mtp.proj
    h, _ = apply_layer(params.mtp.block, h, cfg, "attn_dense", pos=pos)
    h = L.rmsnorm(h, params.mtp.norm, cfg.norm_eps)
    labels2 = torch.cat([labels[:, 1:], labels.new_zeros(
        (labels.shape[0], 1))], dim=1)
    mask2 = torch.cat([mask[:, 1:], mask.new_zeros((mask.shape[0], 1))],
                      dim=1)
    return chunked_ce_loss(h, unembed, labels2, mask2)


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
    ``v``."""
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
            raise _not_ported(f"the decode cache of layer kind {kind!r}")
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
                *, pos: Tensor | None = None) -> tuple[Tensor, Cache]:
    """Tokens [B, S] (one token, or a whole prompt for a cache-writing
    prefill) -> (logits [B, S, V] float32, new cache). ``pos`` are the
    tokens' positions for the rotary embedding, [B, S] (or [B, S, 3] for an
    M-RoPE model, which must be given them: ValueError otherwise); by
    default (as in the reference) every token takes the cache's length
    (:func:`_cache_length`). That is the right position for one token; for
    S > 1 the reference rotates every token of the prompt alike while its
    causal mask places them at length + i, so with rope attention layers
    (MLA's included) the port asks for ``pos`` instead (ValueError)."""
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
    x = params.embed[tokens]
    new_cache = []
    for blk, kind, c in zip(params.blocks, cfg.layer_kinds, cache):
        x, nc = apply_layer(blk, x, cfg, kind, pos=pos, cache=c)
        new_cache.append(nc)
    x = _norm(x, params.final_norm, cfg.norm_eps)
    return _logits(x, params.unembedding()), new_cache


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
