"""~100M-parameter LLaMA-style model for end-to-end training (the
reference's ``examples/train_lm.py`` and ``launch/train.py`` default, and
its ``launch/serve_lm.py`` default; not one of the 10 assigned archs).

12L d=768 12H (GQA kv=4) d_ff=2048 vocab=32000 -> 124.7M params (untied
embedding and unembedding).
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_head=64,
    d_ff=2048,
    vocab=32000,
    layer_pattern=("attn",),
))
