"""Training and serving steps of the port (``src/repro/train/``): the
optimizer (AdamW, optional int8 moments), the microbatched train step,
checkpointing, ``ResilientLoop`` and ``StragglerMonitor``, and the
serving steps. ``remesh`` waits for ``sharding/`` (ROADMAP queue 1 item
2.3)."""
from .optimizer import OptConfig, init_opt_state, apply_updates  # noqa: F401
from .train_step import make_train_step, make_eval_step  # noqa: F401
from .serve_step import (greedy_generate, make_decode_step,  # noqa: F401
                         make_prefill_step)
from .checkpoint import CheckpointManager  # noqa: F401
from .fault_tolerance import ResilientLoop, StragglerMonitor  # noqa: F401
