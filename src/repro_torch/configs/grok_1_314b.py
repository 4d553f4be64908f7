"""Grok-1 314B [hf:xai-org/grok-1; unverified].

Assigned: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8e top-2.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=8, top_k=2),
))
