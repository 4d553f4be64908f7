"""The four assigned input shapes (LM-family): seq_len x global_batch.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), not ``train_step``. ``long_500k`` requires sub-quadratic
decode state and is only run for archs with ``subquadratic=True``
(DESIGN.md section 4); skipped cells are reported, not silently shrunk.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable(arch_cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-not). The skip rules of the assignment brief."""
    if shape.name == "long_500k" and not arch_cfg.subquadratic:
        return False, ("pure full-attention arch: 524k-token decode is "
                       "O(seq) KV read per token; skipped per brief "
                       "(DESIGN.md section 4)")
    if arch_cfg.enc_dec and shape.seq_len > arch_cfg.max_target_len \
            and shape.kind in ("prefill", "decode"):
        return False, (f"whisper decoder position cap is "
                       f"{arch_cfg.max_target_len}; {shape.seq_len}-token "
                       "serve shapes are architecturally invalid")
    return True, ""
