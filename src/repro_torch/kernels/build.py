"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
into ``build/repro_torch/lib<name>.so`` at the repository root (git
ignores ``build/``) and loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds. Nothing here runs at import time:
the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class KernelBuildError(RuntimeError):
    """nvcc failed or could not be found; the message carries its output."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names) -> dict[str, str]:
    """Compile every stale kernel in ``names``, one nvcc process per source,
    all started together. Returns nvcc's report (``-Xptxas -v``: registers,
    shared memory, spills) per built kernel. Raises with nvcc's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))   # atomic: no half library
    if failed:
        raise KernelBuildError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if stale."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
