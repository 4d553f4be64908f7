"""Model zoo of the port: the LM stack of ``src/repro/models/``, one layer
kind at a time. So far the ``rwkv`` kind (RWKV-6) and the dense attention
kinds (GQA, RoPE, KV and ring-buffer caches, SwiGLU) are ported, for
serving and training, with the ``rwkv6-7b``, ``lm-100m``, ``command-r-35b``,
``command-r-plus-104b`` and ``qwen1.5-110b`` configs (ROADMAP queue 1 item
2.2 lists the rest).
"""
from .config import ArchConfig, MLAConfig, MoEConfig, register, get_config, list_configs
from .model import (init_params, decode_step, init_decode_cache,  # noqa: F401
                    train_forward)
