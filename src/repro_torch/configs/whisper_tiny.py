"""Whisper-tiny [arXiv:2212.04356; unverified].

Assigned: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865 — enc-dec,
conv frontend (stub). The conv1d+log-mel frontend is STUBBED: input_specs
provides precomputed 1500-frame embeddings. Decoder positions are learned
and capped at 448 (serve shapes beyond that are reported as
architecturally-invalid cells, DESIGN.md section 4).
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51865,
    pos="learned",
    layer_pattern=("attn",),
    enc_dec=True,
    n_enc_layers=4,
    enc_context=1500,
    max_target_len=448,
))
