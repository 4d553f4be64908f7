"""Architecture configuration + registry (the port's copy of
``src/repro/models/config.py``).

One ``ArchConfig`` instance per ported architecture lives in
``repro_torch/configs/<id>.py`` with the exact published numbers; the same
dataclass drives the reduced smoke configs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeekMoE
    d_expert: int | None = None  # per-expert ffn width (None -> d_ff)
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # DeepSeek-V3 aux-loss-free bias update


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3)."""

    q_rank: int                  # query low-rank compression dim
    kv_rank: int                 # KV latent dim (this is what decode caches)
    d_nope: int                  # per-head non-rotary dim
    d_rope: int                  # per-head rotary dim (shared key rope)
    d_v: int                     # per-head value dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None    # None -> d_model // n_heads
    attn_bias: bool = False      # QKV bias (Qwen1.5)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    pos: str = "rope"            # rope | mrope | none | learned
    layer_pattern: tuple[str, ...] = ("attn",)   # period of layer kinds
    dense_prefix: int = 0        # leading dense layers before MoE (DeepSeek)
    local_window: int = 2048     # window for "local_attn" layers
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp: bool = False            # multi-token-prediction head (DeepSeek-V3)
    enc_dec: bool = False        # Whisper
    n_enc_layers: int = 0
    enc_context: int = 1500      # encoder frames (Whisper audio stub)
    max_target_len: int = 448    # decoder position cap (Whisper)
    frontend: str = "none"       # none | audio_stub | vision_stub
    n_vision_tokens: int = 0     # stub patch-embedding tokens (Qwen2-VL)
    # rwkv6
    rwkv_head_dim: int = 64
    # notes for DESIGN/EXPERIMENTS (sub-quadratic support etc.)
    subquadratic: bool = False   # True -> long_500k decode supported
    note: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else (
            self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers."""
        kinds = []
        if self.dense_prefix:
            kinds += ["attn_dense"] * self.dense_prefix
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(self.layer_pattern[i % len(self.layer_pattern)])
            i += 1
        return tuple(kinds[: self.n_layers])

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        from . import model  # lazy; model computes exact shapes
        return model.count_params(self)

    def active_param_count(self) -> int:
        from . import model
        return model.count_params(self, active_only=True)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # configs register on import
        import importlib
        importlib.import_module("repro_torch.configs")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import importlib
    importlib.import_module("repro_torch.configs")
    return sorted(_REGISTRY)
