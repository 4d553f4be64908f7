"""Fault-tolerant checkpointing: atomic, resumable, retention-managed (the
port of ``src/repro/train/checkpoint.py``).

  * save writes a temporary directory and renames it into place, so a
    crashed save never corrupts the latest checkpoint;
  * the manifest records the step and whatever the caller adds (the data
    cursor), so a restore resumes the exact stream position
    (``synthetic_stream`` is a pure function of the cursor);
  * retention keeps the newest ``keep`` checkpoints;
  * tensors are stored on the host, one ``.npz`` entry per state-dict
    name (``params.npz``) and per optimizer-state name (``opt_state.npz``:
    ``step``, ``m/<param>``, ``v/<param>``, and ``.../code`` and
    ``.../scale`` for a quantized moment), and read back onto the device
    of the tensor they restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _restored(arr: np.ndarray, like: torch.Tensor, key: str
              ) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint entry {key} is {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def _unflatten_into(tree: Any, flat, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return _restored(flat[prefix[:-1]], tree, prefix[:-1])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, params: nn.Module, opt_state: dict,
             extra: dict | None = None) -> str:
        """Write ``params``' state dict, ``opt_state`` and a manifest of
        ``step`` and ``extra`` as checkpoint ``step`` (fetching them to the
        host), then drop all but the newest ``keep``."""
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "params.npz"), **{
                k: _host(v) for k, v in params.state_dict().items()})
            np.savez(os.path.join(tmp, "opt_state.npz"), **{
                k: _host(v) for k, v in _flatten(opt_state).items()})
            manifest = {"step": step, **(extra or {})}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()
        return self._step_dir(step)

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_like: nn.Module, opt_like: dict,
                step: int | None = None) -> tuple[nn.Module, dict, dict]:
        """Checkpoint ``step`` (default the latest): its parameters copied
        into ``params_like`` in place (which is returned), an optimizer
        state shaped as ``opt_like`` on its devices and dtypes, and the
        manifest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "params.npz")) as z:
            flat = dict(z)
        with torch.no_grad():
            for k, t in params_like.state_dict().items():
                t.copy_(_restored(flat[k], t, k))
        with np.load(os.path.join(d, "opt_state.npz")) as z:
            opt = _unflatten_into(opt_like, dict(z))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return params_like, opt, manifest
