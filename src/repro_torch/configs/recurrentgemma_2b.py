"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

Assigned: 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 —
RG-LRU + local attn, 1:2 (two recurrent layers per local-attention layer;
window 2048). Sub-quadratic: runs long_500k decode.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    subquadratic=True,
))
