"""Model zoo of the port: the LM stack of ``src/repro/models/``, one layer
kind at a time. So far the ``rwkv`` kind (RWKV-6) and the ``rwkv6-7b``
config are ported, for serving and training (ROADMAP queue 1 item 2.2
lists the rest).
"""
from .config import ArchConfig, MLAConfig, MoEConfig, register, get_config, list_configs
from .model import (init_params, decode_step, init_decode_cache,  # noqa: F401
                    train_forward)
