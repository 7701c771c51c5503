"""Build and load the hand-written CUDA kernels of `mmlspark_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`.  Nothing
is built at import: a library is built at its first use, or ahead of use
by `build()`, into `csrc/build/` (listed in `.gitignore`).  The file
name carries a hash of the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edited source or header rebuilds and a stale
library is never loaded.  A file lock keeps two processes from building
at once; each compile writes a temporary file that is renamed into
place.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build",
           "ptxas_report", "library"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  #: guarded-by _LOCK


def sources() -> Dict[str, str]:
    """name -> path of every `csrc/*.cu`."""
    return {f[:-3]: os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
            if f.endswith(".cu")}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mmlspark_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return path


def _target(name: str) -> str:
    """The library's path; its name hashes the source, every shared
    `csrc/*.cuh` header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [sources()[name]] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile(nvcc: str, name: str, target: str) -> float:
    t0 = time.perf_counter()
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, sources()[name]],
                          capture_output=True, text=True)
    with open(target[:-3] + ".log", "w", encoding="utf-8") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    seconds = time.perf_counter() - t0
    from ..core.telemetry import device as _device_obs

    _device_obs.note_build(f"csrc/{name}.cu", seconds)
    return seconds


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named kernels (default: every `csrc/*.cu`) that are not
    built yet, one `nvcc` per source, all started together.  Returns the
    seconds each compile took (0.0 for a library already built); the
    compiler's `-Xptxas -v` report lands beside each library as `.log`."""
    names = list(sources()) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = {n: _target(n) for n in names
                    if not os.path.exists(_target(n))}
            secs = {n: 0.0 for n in names}
            if todo:
                nvcc = _nvcc()
                with concurrent.futures.ThreadPoolExecutor(len(todo)) as ex:
                    futs = {n: ex.submit(_compile, nvcc, n, t)
                            for n, t in todo.items()}
                    for n, fut in futs.items():
                        secs[n] = fut.result()
            return secs
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report of a built kernel."""
    with open(_target(name)[:-3] + ".log", encoding="utf-8") as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(_target(name))
        return lib
