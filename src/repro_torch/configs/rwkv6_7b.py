"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf].

Assigned: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
data-dependent decay. Sub-quadratic (constant-size decode state): runs
long_500k decode.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    pos="none",
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    subquadratic=True,
))
