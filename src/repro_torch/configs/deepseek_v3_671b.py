"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

Assigned: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
d_ff=2048 is the per-expert width (the HF config's moe_intermediate_size);
the real model's 3 dense-prefix layers use 18432 — we keep the assigned
2048 everywhere to match the assignment cell exactly (noted deviation).
MLA dims from the HF config: q_lora_rank 1536, kv_lora_rank 512,
qk_nope/rope 128/64, v_head 128.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=2048,
    vocab=129280,
    rope_theta=10000.0,
    layer_pattern=("attn",),
    dense_prefix=3,
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert=2048,
                  router_aux_free=True),
    mla=MLAConfig(q_rank=1536, kv_rank=512, d_nope=128, d_rope=64, d_v=128),
    mtp=True,
))
