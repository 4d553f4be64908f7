"""Ported architecture configs. Importing this package registers them.

``deepseek-v3-671b`` (MLA, the MoE feed-forward with a shared expert and
the aux-free router bias, a dense prefix, the multi-token head),
``grok-1-314b`` (the MoE feed-forward), the dense GQA configs
``command-r-plus-104b``, ``qwen1.5-110b`` and ``command-r-35b`` (the
``attn`` kind), ``minicpm3-4b`` (Multi-head Latent Attention),
``qwen2-vl-7b`` (M-RoPE with the vision stub) and ``rwkv6-7b`` (the
``rwkv`` kind) are ported for serving and training, and so is
``lm-100m`` (the LM launchers' default, registered as in the reference
and outside ``ALL_ARCHS``); the reference's other two configs
(``recurrentgemma-2b``, ``whisper-tiny``; ``src/repro/configs/``) arrive
with the slices that port their layers (ROADMAP queue 1 item 2.2).
``<arch>.py`` holds the exact published config; ``smoke.py`` derives
reduced same-family configs for CPU tests; ``shapes.py`` holds the four
input shapes.
"""
from . import (deepseek_v3_671b, grok_1_314b, command_r_plus_104b,
               qwen1_5_110b, command_r_35b, minicpm3_4b, qwen2_vl_7b,
               rwkv6_7b, lm_100m)
from .shapes import SHAPES, ShapeSpec, applicable
from .smoke import smoke_config

ALL_ARCHS = ["deepseek-v3-671b", "grok-1-314b", "command-r-plus-104b",
             "qwen1.5-110b", "command-r-35b", "minicpm3-4b", "qwen2-vl-7b",
             "rwkv6-7b"]
