"""Build and load the port's CUDA kernels.

Each ``mvd_tpu_torch/csrc/<name>.cu`` has a plain C interface and is compiled
on first use by ``nvcc`` into ``mvd_tpu_torch/_build/lib<name>.so`` for
``sm_90a`` (Hopper), then loaded with ``ctypes``. Nothing is built when a
module is imported: the CPU tests import every module and have no ``nvcc``.
``build_all`` starts one ``nvcc`` per source, all at once.

The port's host C++ (``csrc/<name>.cpp``: the JPEG decoder and the
Objaverse reader, standard library only) is built by ``build_host`` with the
host's ``c++`` into the same directory and loaded by ``load_host``;
``build_all`` builds those it is given beside the ``nvcc`` jobs.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the host sources' flags: no -march=native and no contraction of a*b+c into
# an FMA, so that the float arithmetic is the same on every host (the JAX
# package's reader builds with -march=native and differs by ISA)
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
HOST_CXX = "c++"

_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
build_logs: Dict[str, str] = {}  # ptxas register/shared-memory report per source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Whether ``lib<name>.so`` is missing or older than its ``.cu`` or any
    header under ``csrc/``."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    sources = [os.path.join(CSRC, f"{name}.cu")]
    sources += [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in sources)


def compile_all(jobs: Dict[str, Tuple[str, str]]) -> None:
    """Run one ``nvcc`` per job ``name -> (source, library)``, all at once;
    each library is replaced only when its build succeeds. ptxas's report
    lands in ``build_logs[name]``."""
    nvcc = _nvcc()
    procs = {}
    for name, (src, lib) in jobs.items():
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = lib + f".{os.getpid()}.tmp"
        procs[name] = (tmp, lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(jobs[name][0])} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all(names: Iterable[str], host: Iterable[str] = ()) -> float:
    """Compile the named CUDA sources that are stale (``_stale``), one
    ``nvcc`` each, and the named host sources (``build_host``), one thread
    each, all in parallel. Returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    host = list(host)
    with ThreadPoolExecutor(max(1, len(host))) as pool:
        built = [pool.submit(build_host, name) for name in host]
        stale = [name for name in names if _stale(name)]
        if stale:
            compile_all({n: (os.path.join(CSRC, f"{n}.cu"), _lib_path(n)) for n in stale})
        for f in built:
            f.result()
    return time.perf_counter() - t0


def build_variants(name: str, specs: Iterable[str]) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """For a bench: ``csrc/<name>.cu`` as it stands ("change") and each
    ``LABEL=PATH`` of ``specs`` (another copy of that source, say a parent
    checkout's), one ``nvcc`` each, in parallel, into ``_build/bench/``.
    Prints ptxas's register and spill lines. Returns label -> (the loaded
    library, its path)."""
    out = lambda label: os.path.join(BUILD_DIR, "bench", f"lib{name}_{label}.so")
    sources = {"change": os.path.join(CSRC, f"{name}.cu")}
    sources.update(spec.split("=", 1) for spec in specs)
    jobs = {f"{name}:{label}": (src, out(label)) for label, src in sources.items()}
    compile_all(jobs)
    builds = {}
    for label in sources:
        for line in build_logs[f"{name}:{label}"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {label}: {line.strip()}")
        builds[label] = (ctypes.CDLL(out(label)), out(label))
    return builds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return _libs[name]


def on_device(t: torch.Tensor) -> torch.cuda.device:
    """The context every kernel launch runs in: ``t``'s device made current,
    since the C entries read ``cudaGetDevice()`` for per-device attributes
    and launch on ``t``'s stream."""
    return torch.cuda.device(t.device)


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry returned an error: a CUDA error code,
    or minus a driver ``CUresult`` (a tensor-map encode that failed)."""
    if err < 0:
        raise RuntimeError(f"{what}: tensor-map encode failed, CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _source_mtime(src: str) -> float:
    """The newest mtime of ``src`` and the headers of ``csrc/`` it includes
    by name (``#include "..."``)."""
    newest = os.path.getmtime(src)
    with open(src) as f:
        for line in f:
            m = re.match(r'\s*#include "([^"]+)"', line)
            if m and os.path.exists(os.path.join(CSRC, m.group(1))):
                newest = max(newest, os.path.getmtime(os.path.join(CSRC, m.group(1))))
    return newest


def build_host(name: str, build_dir: Optional[str] = None) -> str:
    """Compile ``csrc/<name>.cpp`` into ``<build_dir>/lib<name>.so`` (default
    ``_build/``) with ``HOST_CXX`` and ``HOST_FLAGS`` when the library is
    missing or older than its source; returns the library's path. Builds of
    one library are serialized across processes by a file lock, and the
    compiler writes a temporary file that is renamed into place. Raises
    without a compiler or when the build fails, quoting the compiler."""
    build_dir = build_dir or BUILD_DIR
    src = os.path.join(CSRC, f"{name}.cpp")
    lib = os.path.join(build_dir, f"lib{name}.so")
    os.makedirs(build_dir, exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib) and os.path.getmtime(lib) >= _source_mtime(src):
            return lib
        exe = shutil.which(HOST_CXX)
        if exe is None:
            raise RuntimeError(f"no C++ compiler: {HOST_CXX!r} is not on PATH, so {name}.cpp "
                               "cannot be built")
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([exe, *HOST_FLAGS, "-o", tmp, src], capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {name}.cpp failed ({HOST_CXX} exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load_host(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed
    (``build_host``); ``bind`` sets its functions' ctypes signatures once.
    ``CDLL`` releases the interpreter lock around each call, so the loader's
    threads decode in parallel."""
    with _host_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_host(name))
            bind(lib)
            _libs[name] = lib
        return _libs[name]
