"""Serving steps of the port (``src/repro/train/serve_step.py``). The
optimizer, train step, checkpointing and fault tolerance of
``src/repro/train/`` are not ported yet (ROADMAP queue 1 item 14)."""
from .serve_step import make_prefill_step, make_decode_step, greedy_generate
