"""Serving steps: prefill (last-position logits) + decode (one token or a
cache-writing prompt) + a batched greedy loop.

Port of ``src/repro/train/serve_step.py``. PyTorch runs eagerly, so the
steps are plain closures (no jit). They run under ``torch.no_grad()``, so
no autograd graph is kept and the recurrence takes the ``rwkv_scan``
kernel even for a model whose parameters require gradients (one being
trained). Attention layers keep a KV cache whose length is a host int,
so a decode step makes no blocking transfer.

On a mesh: place the parameters (``sharding.rules.place_parameters`` with
``param_pspecs``), the batch (``batch_pspec``) and the cache
(``cache_pspecs``) as DTensors and pass ``shard=make_shard_fn(mesh)``;
the steps then run on DTensors under ``train_step.replicating``, and
RWKV's recurrence runs ``rwkv_scan`` on each rank's (batch, head) shard.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import layers as L
from ..models import model as M
from ..models.config import ArchConfig
from .train_step import replicating

Tensor = torch.Tensor


def make_prefill_step(cfg: ArchConfig, *, shard=M.NO_SHARD) -> Callable:
    """Forward over the full prompt producing last-position logits [B, V]
    float32, attention layers rotating by positions 0 .. S-1, or, for an
    M-RoPE model, by the batch's ``pos3`` [B, S, 3]. With the vision stub
    the batch's ``vision_embeds`` [B, min(n_vision_tokens, S), d] take the
    place of the first embeddings, as in the reference. (The cache-writing
    prefill is ``decode_step`` with S > 1, given ``pos`` where the model
    has rope or M-RoPE attention layers.) An encoder-decoder config raises
    ValueError (``model._decoder_only``): the reference's prefill runs its
    decoder without the encoder."""
    M._decoder_only(cfg, "make_prefill_step")

    @torch.no_grad()
    def prefill(params: M.LM, batch: dict[str, Tensor]) -> Tensor:
        with replicating(params.parameters()):
            return _prefill(params, batch)

    def _prefill(params: M.LM, batch: dict[str, Tensor]) -> Tensor:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = shard(L.take_rows(params.embed, tokens), "act_resid")
        if cfg.pos == "mrope":
            pos = batch["pos3"]
        else:
            pos = M.positions(cfg, b, s, tokens.device)
        if cfg.frontend == "vision_stub" and cfg.n_vision_tokens:
            nv = min(cfg.n_vision_tokens, s)
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x[:, nv:]],
                          dim=1)
        x = M._run_layers(params, x, cfg, pos=pos, shard=shard)
        x = M._norm(x[:, -1], params.final_norm, cfg.norm_eps)
        return shard(M._logits(x, params.unembedding()), "logits_last")

    return prefill


def make_decode_step(cfg: ArchConfig, *, shard=M.NO_SHARD) -> Callable:
    """Returns ``decode(params, cache, tokens, pos=None)``: ``decode_step``
    without autograd; ``pos`` [B, S, 3] for an M-RoPE model (the
    reference's ``pos3``)."""

    @torch.no_grad()
    def decode(params: M.LM, cache: M.Cache, tokens: Tensor,
               pos: Tensor | None = None):
        with replicating(params.parameters()):
            return M.decode_step(params, cache, tokens, cfg, pos=pos,
                                 shard=shard)
    return decode


@torch.no_grad()
def greedy_generate(params: M.LM, cfg: ArchConfig, prompt: Tensor,
                    max_new: int, cache_len: int,
                    dtype=torch.float32) -> Tensor:
    """Simple batched greedy loop: ``prompt`` [B, P] -> [B, max_new] int32
    tokens, on the prompt's device. Every step takes ``decode_step``'s
    default position, so an M-RoPE model raises there (ValueError), as
    the reference's loop fails on one. An encoder-decoder model raises
    ValueError at once (``model._decoder_only``)."""
    M._decoder_only(cfg, "greedy_generate")
    b = prompt.shape[0]
    cache = M.init_decode_cache(cfg, b, cache_len, dtype,
                                device=prompt.device)

    # feed the prompt one token at a time (prefill-by-decode; simple + exact)
    logits = None
    for i in range(prompt.shape[1]):
        logits, cache = M.decode_step(params, cache, prompt[:, i: i + 1], cfg)
    outs = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for _ in range(max_new):
        outs.append(tok)
        logits, cache = M.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    return torch.cat(outs, dim=1)
