"""Model zoo of the port: the LM stack of ``src/repro/models/``, every
layer kind of the reference (``rwkv``, ``rglru``, the dense, local,
M-RoPE, MLA and MoE attention kinds) and the Whisper encoder-decoder,
for serving and training, with all ten of the reference's configs and
``lm-100m``.
"""
from .config import ArchConfig, MLAConfig, MoEConfig, register, get_config, list_configs
from .model import (init_params, decode_step, init_decode_cache,  # noqa: F401
                    train_forward)
