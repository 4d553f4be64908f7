"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01; unverified].

Assigned: 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 —
GQA, no-bias.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab=256000,
    layer_pattern=("attn",),
))
