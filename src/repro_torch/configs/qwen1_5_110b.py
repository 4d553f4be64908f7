"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family; hf].

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 —
QKV bias.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    attn_bias=True,
    layer_pattern=("attn",),
))
