"""Build and load the port's CUDA kernels.

Each ``mvd_tpu_torch/csrc/<name>.cu`` has a plain C interface and is compiled
on first use by ``nvcc`` into ``mvd_tpu_torch/_build/lib<name>.so`` for
``sm_90a`` (Hopper), then loaded with ``ctypes``. Nothing is built when a
module is imported: the CPU tests import every module and have no ``nvcc``.
``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # ptxas register/shared-memory report per source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src = os.path.join(CSRC, f"{name}.cu")
    lib = _lib_path(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build_all(names: Iterable[str]) -> float:
    """Compile the named sources that are missing or older than their
    ``.cu``, one ``nvcc`` each, in parallel. Returns the wall seconds."""
    t0 = time.perf_counter()
    stale = [name for name in names if _stale(name)]
    if not stale:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in stale:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
