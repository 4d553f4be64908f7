"""The port stands alone: importing it loads neither JAX nor the JAX
package, and its entry points default to the card."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_no_reference():
    names = _modules()
    assert {"repro_torch.api", "repro_torch.convert",
            "repro_torch.kernels.knn_tile", "repro_torch.kernels.build",
            "repro_torch.core.grid"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_index_defaults_to_cuda():
    """Without a CUDA device and without ``device="cpu"``, ``build_index``
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.api import SearchParams, build_index
    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(pts, SearchParams(radius=0.2, k=4))
    index = build_index(pts, SearchParams(radius=0.2, k=4), device="cpu")
    assert index.points.device.type == "cpu"
