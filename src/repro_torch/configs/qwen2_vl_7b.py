"""Qwen2-VL-7B [arXiv:2409.12191; hf].

Assigned: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 —
M-RoPE, dynamic resolution. The vision tower is a STUB per the brief:
``input_specs()`` provides precomputed patch embeddings + 3-D M-RoPE
positions; the backbone here is the language decoder.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    attn_bias=True,
    pos="mrope",
    layer_pattern=("attn",),
    frontend="vision_stub",
    n_vision_tokens=1024,
))
