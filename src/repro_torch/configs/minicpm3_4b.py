"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf].

Assigned: 62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448 — MLA.
MLA dims from the HF config: q_lora_rank 768, kv_lora_rank 256,
qk_nope/rope 64/32, v_head 64.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab=73448,
    layer_pattern=("attn",),
    mla=MLAConfig(q_rank=768, kv_rank=256, d_nope=64, d_rope=32, d_v=64),
))
