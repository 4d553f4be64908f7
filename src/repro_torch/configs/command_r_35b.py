"""Command R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

Assigned: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 —
GQA, no-bias.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab=256000,
    layer_pattern=("attn",),
))
