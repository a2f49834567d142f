"""Build, bind and launch the port's hand-written CUDA sources.

Each ``csrc/<name>.cu`` exports a plain C interface — ``<name>_launch``
returning the launch's ``cudaError_t`` and ``<name>_error_string`` — and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/repro_torch/lib<name>.so`` at the repository root, then loaded with
``ctypes``.  The library is rebuilt when any source under ``csrc/`` is
newer than it, so a fresh checkout builds from its own sources alone.
:func:`launch` raises on a refused launch and counts the successful ones
per library (:func:`launch_counts`), so a run can show which kernels it
went through; :func:`build_counts` counts the ``nvcc`` runs per library,
so a run can show that a step built nothing.  Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "build_all", "load",
           "build_log", "build_counts", "launch", "launch_counts",
           "reset_launch_counts"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOGS: dict = {}
_LAUNCHES: dict = {}
_BUILDS: dict = {}
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
    _BUILDS[name] = _BUILDS.get(name, 0) + 1
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{_LOGS[name]}")
    os.replace(tmp, out)              # atomic: concurrent builders race safely
    return out


def build_all(names, *, force: bool = False) -> dict:
    """Build several libraries at once — one ``nvcc`` per source, all
    started together — and return each one's wall seconds.  The first
    failure raises after every build has ended."""
    def timed(name):
        t0 = time.perf_counter()
        build(name, force=force)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


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


def build_counts() -> dict:
    """``nvcc`` runs per library in this process (up-to-date libraries
    are not rebuilt, so a warm process shows none)."""
    return dict(_BUILDS)


def launch(name: str, argtypes: list, args: tuple, what: str = "") -> None:
    """Call ``<name>_launch(*args)`` of the built library (declared with
    ``argtypes``: every pointer and the stream as ``c_void_p``, so none is
    cut to 32 bits) and count it; a non-zero ``cudaError_t`` raises, with
    ``what`` (the call's shapes) in the message."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    err = fn(*args)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed ({what}): {msg}")
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> dict:
    """Successful launches per library in this process."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
