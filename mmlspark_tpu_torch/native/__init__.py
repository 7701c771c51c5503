"""The port's host JPEG decoder: ctypes bindings to a library built here.

Counterpart of the JPEG half of the JAX package's `native` module
(`jpeg_available`, `jpeg_probe`, `decode_jpeg_bgr`,
`decode_jpeg_bgr_into`; its murmur3, histogram and CSV entries are not
copied).  The library is built with g++ at first use, from one of two
sources with the same C entries, by what the machine has:

- `src/jpeg_libjpeg.cpp` where `jpeglib.h` exists: a copy of the JAX
  package's libjpeg entries, so the pixels equal its decoder's byte for
  byte (BGR straight from libjpeg-turbo's `JCS_EXT_BGR`, DCT-domain
  `scale_denom`, truncated streams rejected);
- `src/jpeg_nvjpeg.cpp` where it does not and the CUDA toolkit's
  `nvjpeg.h` does: nvJPEG decodes on the card into interleaved BGR and
  the pixels are copied into the caller's buffer.  Its IDCT and chroma
  upsampling are not libjpeg's (the card tests bound the difference);
  it has no `scale_denom` other than 1.

Where neither builds, `jpeg_available()` is False and the featurizer
keeps its general path (PIL), as the JAX package does without libjpeg.
The library goes to `native/build/` (listed in `.gitignore`) under a
name that hashes its source and flags; a file lock keeps two processes
from building at once.  The C calls release the GIL, so decode threads
run in parallel.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["jpeg_available", "jpeg_backend", "jpeg_probe", "decode_jpeg_bgr",
           "decode_jpeg_bgr_into", "build_error", "MAX_JPEG_PIXELS"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

# same default ceiling as PIL's DecompressionBombError threshold
MAX_JPEG_PIXELS = 178_956_970

_LOCK = threading.Lock()
_STATE: dict = {}  #: guarded-by _LOCK — "lib", "backend", "error" once tried


def _cuda_home() -> str:
    """The CUDA toolkit's root (a deployment path: CUDA_HOME, else the
    toolkit's standard place)."""
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _has_header(cxx: str, header: str, *flags: str) -> bool:
    proc = subprocess.run([cxx, "-E", "-x", "c++", *flags, "-"],
                          input=f"#include <{header}>\n", capture_output=True,
                          text=True, timeout=60)
    return proc.returncode == 0


def _choose(cxx: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """(backend, link flags) by what the machine has, or None."""
    if _has_header(cxx, "jpeglib.h"):
        return "libjpeg", ("-ljpeg",)
    cuda = _cuda_home()
    if _has_header(cxx, "nvjpeg.h", f"-I{cuda}/include"):
        lib = f"{cuda}/lib64"
        return "nvjpeg", (f"-I{cuda}/include", f"-L{lib}", "-lnvjpeg",
                          "-lcudart_static", "-ldl", "-lrt", "-lpthread",
                          f"-Wl,-rpath,{lib}")
    return None


def _build(cxx: str, backend: str, flags: Tuple[str, ...]) -> str:
    """Path of the built library (built now unless already there)."""
    src = os.path.join(_DIR, "src", f"jpeg_{backend}.cpp")
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + flags).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    target = os.path.join(BUILD_DIR,
                          f"libmmk_jpeg_{backend}-{digest.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(target):
                tmp = f"{target}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    [cxx, *_CXX_FLAGS, "-o", tmp, src, *flags],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} failed for native/src/"
                                       f"jpeg_{backend}.cpp:\n{proc.stderr}")
                os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _load() -> Optional[ctypes.CDLL]:
    """The decoder library, built and loaded at the first call; None
    where no backend builds (the reason is `build_error()`)."""
    with _LOCK:
        if _STATE:
            return _STATE["lib"]
        lib, backend, error = None, None, None
        cxx = shutil.which("g++") or shutil.which("c++")
        choice = _choose(cxx) if cxx else None
        if choice is None:
            error = ("no C++ compiler" if not cxx else
                     "neither jpeglib.h nor the CUDA toolkit's nvjpeg.h found")
        else:
            try:
                lib = ctypes.CDLL(_build(cxx, *choice))
                backend = choice[0]
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                error = str(e)
        if lib is not None:
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.mml_jpeg_probe.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
                i32p]
            lib.mml_jpeg_decode_bgr.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64, i32p, i32p, i32p]
            lib.mml_jpeg_probe.restype = ctypes.c_int32
            lib.mml_jpeg_decode_bgr.restype = ctypes.c_int32
        _STATE.update(lib=lib, backend=backend, error=error)
        return lib


def jpeg_available() -> bool:
    """True when a JPEG decoder library is built and loaded."""
    return _load() is not None


def jpeg_backend() -> Optional[str]:
    """"libjpeg", "nvjpeg", or None where no decoder builds."""
    _load()
    return _STATE["backend"]


def build_error() -> Optional[str]:
    """Why no decoder library is loaded (None when one is)."""
    _load()
    return _STATE["error"]


def _check_scale(scale_denom: int) -> None:
    if scale_denom != 1 and jpeg_backend() == "nvjpeg":
        raise ValueError(f"scale_denom {scale_denom}: nvJPEG has no "
                         "DCT-domain scaling (the libjpeg backend does)")


def _probe(lib, buf: np.ndarray, scale_denom: int):
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mml_jpeg_probe(buf.ctypes.data, len(buf), int(scale_denom),
                            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0 or h.value * w.value > MAX_JPEG_PIXELS:
        return None
    return (h.value, w.value, c.value)


def _decode(lib, buf: np.ndarray, scale_denom: int, out: np.ndarray):
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mml_jpeg_decode_bgr(buf.ctypes.data, len(buf), int(scale_denom),
                                 out.ctypes.data, out.nbytes, ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c))
    return rc == 0, (h.value, w.value, c.value)


def jpeg_probe(data: bytes, scale_denom: int = 1):
    """Header-only (h, w, c) of a JPEG stream (no pixel decode), so that
    callers can group rows by output shape and allocate chunk buffers
    before any decode.  None when unavailable, invalid or bomb-sized."""
    lib = _load()
    if lib is None or not data:
        return None
    _check_scale(scale_denom)
    return _probe(lib, np.frombuffer(data, np.uint8), scale_denom)


def decode_jpeg_bgr(data: bytes, scale_denom: int = 1) -> Optional[np.ndarray]:
    """Decode JPEG bytes to an HWC uint8 array in BGR order (gray: 1
    channel); None when no decoder is built or the stream is invalid.
    `scale_denom` in {1, 2, 4, 8} decodes at reduced resolution in the
    DCT domain (libjpeg backend only)."""
    lib = _load()
    if lib is None or not data:
        return None
    _check_scale(scale_denom)
    buf = np.frombuffer(data, np.uint8)
    shape = _probe(lib, buf, scale_denom)
    if shape is None:  # invalid, or the decompression-bomb guard: the dims
        return None    # come from an untrusted header
    out = np.empty(shape, np.uint8)
    ok, got = _decode(lib, buf, scale_denom, out)
    return out if ok and got == shape else None


def decode_jpeg_bgr_into(data: bytes, out: np.ndarray,
                         scale_denom: int = 1) -> bool:
    """Decode JPEG bytes straight into a preallocated HWC uint8 view (one
    image slot of an [N, H, W, C] chunk buffer): no intermediate array.
    `out` must be C-contiguous and match the decoded (h, w, c) exactly.
    Returns False on any mismatch or decode failure (the caller falls
    back or drops the row)."""
    lib = _load()
    if lib is None:
        return False
    if not out.flags["C_CONTIGUOUS"] or out.dtype != np.uint8:
        raise ValueError("decode_jpeg_bgr_into: need C-contiguous uint8 out")
    if not data:
        return False
    _check_scale(scale_denom)
    ok, got = _decode(lib, np.frombuffer(data, np.uint8), scale_denom, out)
    return ok and out.shape == got
