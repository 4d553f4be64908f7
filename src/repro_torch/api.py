"""``repro_torch.api``: the functional neighbor-search API of the PyTorch
port (``build_index`` / ``plan_query`` / ``execute_plan`` / ``query``);
see ``repro_torch/core/api.py``."""
from .core.api import *  # noqa: F401,F403
from .core.api import __all__  # noqa: F401
