"""Serving steps of the port (``src/repro/train/serve_step.py``) and the
``StragglerMonitor`` of ``src/repro/train/fault_tolerance.py``. The
optimizer, train step, checkpointing, ``ResilientLoop`` and ``remesh``
of ``src/repro/train/`` are not ported yet (ROADMAP queue 1)."""
from .fault_tolerance import StragglerMonitor  # noqa: F401
from .serve_step import make_prefill_step, make_decode_step, greedy_generate
