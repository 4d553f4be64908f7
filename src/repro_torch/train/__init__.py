"""Training and serving steps of the port (``src/repro/train/``): the
optimizer (AdamW, optional int8 moments; ``opt_state_specs``, its state
on the meta device), the microbatched train step, checkpointing,
``ResilientLoop``, ``StragglerMonitor`` and ``remesh`` (elastic
re-sharding of DTensors onto a new mesh), and the serving steps."""
from .optimizer import (OptConfig, apply_updates,  # noqa: F401
                        init_opt_state, opt_state_specs)
from .train_step import make_train_step, make_eval_step  # noqa: F401
from .serve_step import (greedy_generate, make_decode_step,  # noqa: F401
                         make_prefill_step)
from .checkpoint import CheckpointManager  # noqa: F401
from .fault_tolerance import (ResilientLoop, StragglerMonitor,  # noqa: F401
                              remesh)
