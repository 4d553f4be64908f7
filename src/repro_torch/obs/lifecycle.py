"""Reset-safety registration hook (a copy of the reference's
``obs/lifecycle.py``; plain Python).

``repro_torch.obs.reset()`` clears the metrics registry and the span
ring, but components built on top of them own state that reset cannot
see. They register their own reset callable here at import time::

    from .lifecycle import on_reset
    on_reset(BOARD.reset)

``obs.reset()`` then runs every registered hook after clearing the core
state, so two back-to-back test scenarios start from clean counters.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_HOOKS: list = []


def on_reset(fn) -> None:
    """Register ``fn()`` to run on every ``repro_torch.obs.reset()``.
    Idempotent: registering the same callable twice keeps one entry."""
    with _lock:
        if fn not in _HOOKS:
            _HOOKS.append(fn)


def run_reset_hooks() -> int:
    """Run every registered hook (called by ``obs.reset``); returns the
    hook count. A hook that raises propagates — a reset that silently
    half-works is worse than a loud test failure."""
    with _lock:
        hooks = list(_HOOKS)
    for fn in hooks:
        fn()
    return len(hooks)
