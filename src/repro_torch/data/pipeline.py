"""Synthetic token pipeline: batches for every arch family (the port of
``src/repro/data/pipeline.py``).

``batch_specs`` returns meta tensors (shape and dtype stand-ins, nothing
allocated); ``make_batch`` draws a random batch with the same fields from
an explicit ``torch.Generator``; ``synthetic_stream`` is the
deterministic, checkpoint-resumable training stream: the batch at step
``s`` is a pure function of ``(seed, s)``, so a restore seeks by step
index. The draws are PyTorch's, so the batches are not the reference's
bit for bit (nor the CPU's the card's), only the same fields and
distributions. Entry points run on the card unless asked for the CPU.
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from ..core.api import resolve_device
from ..models.config import ArchConfig

Tensor = torch.Tensor


def _fields(cfg: ArchConfig, batch: int, seq: int, dtype) -> dict:
    """name -> (shape, dtype) of every model input of ``cfg``."""
    if cfg.enc_dec:
        seq = min(seq, cfg.max_target_len)
    fields = {"tokens": ((batch, seq), torch.int32),
              "labels": ((batch, seq), torch.int32),
              "mask": ((batch, seq), torch.float32)}
    if cfg.pos == "mrope":
        fields["pos3"] = ((batch, seq, 3), torch.int32)
    if cfg.frontend == "vision_stub" and cfg.n_vision_tokens:
        fields["vision_embeds"] = (
            (batch, min(cfg.n_vision_tokens, seq), cfg.d_model), dtype)
    if cfg.enc_dec:
        fields["enc_input"] = ((batch, cfg.enc_context, cfg.d_model), dtype)
    return fields


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict[str, Tensor]:
    """Meta-tensor stand-ins for every model input (the reference's
    ``ShapeDtypeStruct``s; its stub embeddings are bfloat16)."""
    return {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in
            _fields(cfg, batch, seq, torch.bfloat16).items()}


def make_batch(cfg: ArchConfig, batch: int, seq: int,
               generator: torch.Generator, dtype=torch.float32, *,
               device="cuda") -> dict[str, Tensor]:
    """A random batch with the fields of ``batch_specs``, drawn from
    ``generator`` (which lives on ``device``): uniform tokens, labels the
    tokens shifted left by one, the last position (and any vision stub
    tokens) masked out."""
    dev = resolve_device(device)
    if cfg.enc_dec:
        seq = min(seq, cfg.max_target_len)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           device=dev, dtype=torch.int32)
    mask = torch.ones((batch, seq), dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1),
           "mask": mask}
    nv = (min(cfg.n_vision_tokens, seq) if cfg.frontend == "vision_stub"
          else 0)
    if cfg.pos == "mrope":
        # text tokens: all three position streams equal; vision stub tokens
        # get (t, h, w) grid positions
        p = torch.arange(seq, dtype=torch.int32, device=dev)[None, :, None]
        p = p.expand(batch, seq, 3).clone()
        if nv:
            side = max(1, int(math.sqrt(nv)))
            i = torch.arange(nv, dtype=torch.int32, device=dev)
            p[:, :nv] = torch.stack([torch.zeros_like(i), i // side,
                                     i % side], -1)
        out["pos3"] = p
    if nv:
        out["vision_embeds"] = (torch.randn(
            (batch, nv, cfg.d_model), generator=generator, device=dev,
            dtype=torch.float32) * 0.02).to(dtype)
        out["mask"][:, :nv] = 0.0                 # no loss on vision
    if cfg.enc_dec:
        out["enc_input"] = (torch.randn(
            (batch, cfg.enc_context, cfg.d_model), generator=generator,
            device=dev, dtype=torch.float32) * 0.02).to(dtype)
    return out


def _step_seed(seed: int, step: int) -> int:
    """The generator seed of the stream's batch at ``step``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def synthetic_stream(cfg: ArchConfig, batch: int, seq: int, *,
                     start_step: int = 0, seed: int = 0,
                     dtype=torch.float32, device="cuda"
                     ) -> Iterator[dict[str, Tensor]]:
    """Deterministic resumable stream: the batch at step s is drawn from a
    generator seeded by ``(seed, s)`` alone, so a checkpoint restore
    resumes exactly. Raises at once without a card unless ``device`` is
    the CPU."""
    dev = resolve_device(device)

    def stream():
        gen = torch.Generator(device=dev)
        step = start_step
        while True:
            gen.manual_seed(_step_seed(seed, step))
            yield make_batch(cfg, batch, seq, gen, dtype, device=dev)
            step += 1

    return stream()
