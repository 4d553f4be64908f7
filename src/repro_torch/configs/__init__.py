"""Ported architecture configs. Importing this package registers them.

All ten of the reference's configs (``src/repro/configs/``) are ported
for serving and training: ``deepseek-v3-671b`` (MLA, the MoE feed-forward
with a shared expert and the aux-free router bias, a dense prefix, the
multi-token head), ``grok-1-314b`` (the MoE feed-forward),
``recurrentgemma-2b`` (RG-LRU with local attention), the dense GQA
configs ``command-r-plus-104b``, ``qwen1.5-110b`` and ``command-r-35b``
(the ``attn`` kind), ``minicpm3-4b`` (Multi-head Latent Attention),
``qwen2-vl-7b`` (M-RoPE with the vision stub), ``whisper-tiny`` (the
encoder-decoder; trained through ``train_forward``, served by its decode
pieces, not by ``decode_step``) and ``rwkv6-7b`` (the ``rwkv`` kind); so
is ``lm-100m`` (the LM launchers' default, registered as in the
reference and outside ``ALL_ARCHS``). ``<arch>.py`` holds the exact
published config; ``smoke.py`` derives reduced same-family configs for
CPU tests; ``shapes.py`` holds the four input shapes.
"""
from . import (deepseek_v3_671b, grok_1_314b, recurrentgemma_2b,
               command_r_plus_104b, qwen1_5_110b, command_r_35b,
               minicpm3_4b, qwen2_vl_7b, whisper_tiny, rwkv6_7b, lm_100m)
from .shapes import SHAPES, ShapeSpec, applicable
from .smoke import smoke_config

ALL_ARCHS = [
    "deepseek-v3-671b", "grok-1-314b", "recurrentgemma-2b",
    "command-r-plus-104b", "qwen1.5-110b", "command-r-35b",
    "minicpm3-4b", "qwen2-vl-7b", "whisper-tiny", "rwkv6-7b",
]
