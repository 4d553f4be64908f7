"""Reduced same-family smoke configs: small layers/width/experts/vocab,
pattern-preserving, runnable on CPU in a forward/train step."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    d_head = 16
    d_model = 64
    # keep at least one full pattern period + prefix + tail representation
    period = len(cfg.layer_pattern)
    n_layers = cfg.dense_prefix + 2 * period + (1 if period > 1 else 0)
    moe = None
    if cfg.moe is not None:
        # capacity_factor 8: dropless at smoke scale so the decode-vs-
        # parallel equivalence test is exact (production keeps 1.25, where
        # capacity drops are expected behavior)
        moe = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                        n_shared=cfg.moe.n_shared,
                        d_expert=32 if cfg.moe.d_expert else None,
                        router_aux_free=cfg.moe.router_aux_free,
                        capacity_factor=8.0)
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_rank=32, kv_rank=16, d_nope=16, d_rope=8, d_v=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=96,
        vocab=256,
        moe=moe,
        mla=mla,
        local_window=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_context=16,
        max_target_len=64,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
        rwkv_head_dim=16,
    )
