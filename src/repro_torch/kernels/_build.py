"""Build the port's hand-written CUDA sources at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/lib<name>.so`` at
the repository root, then loaded with ``ctypes``.  The library is rebuilt
when any source under ``csrc/`` is newer than it, so a fresh checkout
builds from its own sources alone.
Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "load", "build_log"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOGS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    """nvcc as PyTorch's extension builder finds it: ``$CUDA_HOME`` or
    ``$CUDA_PATH``, then ``PATH``, then the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    nvcc = (str(Path(home) / "bin" / "nvcc") if home
            else shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found ({nvcc}): set CUDA_HOME to the "
                           "CUDA toolkit")
    return nvcc


def _sources_mtime() -> float:
    return max(p.stat().st_mtime for p in CSRC_DIR.glob("*.cu*"))


def build(name: str, *, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; returns
    the library path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept for :func:`build_log`."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if not force and out.exists() \
            and out.stat().st_mtime >= _sources_mtime():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{_LOGS[name]}")
    os.replace(tmp, out)              # atomic: concurrent builders race safely
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def build_log(name: str) -> str:
    """The compiler output of this process's last build of ``name`` ("" if
    the library was already up to date)."""
    return _LOGS.get(name, "")
