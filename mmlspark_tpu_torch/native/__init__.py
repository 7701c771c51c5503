"""The port's host JPEG decoder: ctypes bindings to a library built here.

Counterpart of the JPEG half of the JAX package's `native` module
(`jpeg_available`, `jpeg_probe`, `decode_jpeg_bgr`,
`decode_jpeg_bgr_into`; its murmur3, histogram and CSV entries are not
copied).  The library is built at first use, from one of two sources
with the same C entries, by what the machine has:

- `src/jpeg_libjpeg.cpp` where `jpeglib.h` exists (g++): a copy of the
  JAX package's libjpeg entries, so the pixels equal its decoder's byte
  for byte (BGR straight from libjpeg-turbo's `JCS_EXT_BGR`, DCT-domain
  `scale_denom`, truncated streams rejected);
- `src/jpeg_nvjpeg.cpp` with the kernel `src/jpeg_ycc.cu` where it does
  not and the CUDA toolkit's `nvjpeg.h` does (nvcc, `sm_90a`): nvJPEG
  decodes on the card into the component planes, and the kernel (C2)
  upsamples and converts them to BGR with libjpeg's arithmetic
  (`jdsample.c`, `jdcolor.c`), so the pixels differ from libjpeg's only
  by nvJPEG's IDCT; the pixels are copied into the caller's buffer.  It
  has no `scale_denom` other than 1.

Both also give a stream's layout (`jpeg_layout`) and its component
planes (`decode_jpeg_planes`: libjpeg's `raw_data_out`, nvJPEG's planes),
the input of the upsampling and colour conversion, whose plain version
(`ops/jpeg_color.py`) the tests hold against libjpeg and the kernel.

Where neither backend's headers exist, `jpeg_available()` is False and
the featurizer keeps its general path (PIL), as the JAX package does
without libjpeg.  A stream the decoder refuses (not a JPEG, truncated,
CMYK) gives None / False, and the caller may decode it another way, as
the JAX package does with a stream libjpeg refuses.  Anything else raises
`DecoderError`, and nothing decodes in its place: a backend the machine
has that fails to build, a failure of the card or of nvJPEG in a probe or
a decode (no handle, no stream, no device memory, an nvJPEG error, a
refused launch), and nvJPEG's view of a stream disagreeing with its
header.  The library goes to `native/build/` (listed in `.gitignore`)
under a name that hashes its sources and flags; a file lock keeps two
processes from building at once.  The C calls release the GIL, so decode
threads run in parallel.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["jpeg_available", "jpeg_backend", "jpeg_probe", "decode_jpeg_bgr",
           "decode_jpeg_bgr_into", "build_error", "jpeg_layout",
           "decode_jpeg_planes", "ycc_library", "ycc_launches",
           "reset_ycc_launches", "build_log", "DecoderError", "JpegLayout",
           "MAX_JPEG_PIXELS"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
# the nvJPEG backend with its C2 kernel, as the port's kernels build
# (ops/_build.py): nvcc for sm_90a, a plain C interface
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC,-Wall", "-Xptxas", "-v")
_SOURCES = {"libjpeg": ("jpeg_libjpeg.cpp",),
            "nvjpeg": ("jpeg_nvjpeg.cpp", "jpeg_ycc.cu", "jpeg_ycc.h")}

# same default ceiling as PIL's DecompressionBombError threshold
MAX_JPEG_PIXELS = 178_956_970

_LOCK = threading.Lock()
_STATE: dict = {}  #: guarded-by _LOCK — "lib", "backend", "error", "path" once tried


class DecoderError(RuntimeError):
    """The decoder the machine has failed to build, or a probe or decode
    failed on the card or in nvJPEG (not a refused stream: those give
    None / False)."""


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
    """(backend, compile and link command) by what the machine has, or
    None."""
    if _has_header(cxx, "jpeglib.h"):
        return "libjpeg", (cxx, *_CXX_FLAGS, "-ljpeg")
    cuda = _cuda_home()
    if _has_header(cxx, "nvjpeg.h", f"-I{cuda}/include"):
        nvcc = shutil.which("nvcc") or f"{cuda}/bin/nvcc"
        lib = f"{cuda}/lib64"
        return "nvjpeg", (nvcc, *_NVCC_FLAGS, f"-I{cuda}/include",
                          f"-L{lib}", "-lnvjpeg", "-Xlinker", f"-rpath,{lib}")
    return None


def _target(backend: str, command: Tuple[str, ...]) -> str:
    """The library's path; its name hashes the sources and the command."""
    digest = hashlib.sha256(" ".join(command[1:]).encode())
    for name in _SOURCES[backend]:
        with open(os.path.join(_DIR, "src", name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libmmk_jpeg_{backend}-{digest.hexdigest()[:16]}.so")


def _build(backend: str, command: Tuple[str, ...]) -> str:
    """Path of the built library (built now unless already there); the
    compiler's output lands beside it as `.log`."""
    target = _target(backend, command)
    srcs = [os.path.join(_DIR, "src", n) for n in _SOURCES[backend]
            if not n.endswith(".h")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(target):
                tmp = f"{target}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    [command[0], "-o", tmp, *srcs, *command[1:]],
                    capture_output=True, text=True, timeout=600)
                with open(target[:-3] + ".log", "w", encoding="utf-8") as f:
                    f.write(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{os.path.basename(command[0])} failed for "
                        f"native/src/{' '.join(_SOURCES[backend])}:\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def build_log() -> Optional[str]:
    """The compiler's output for the loaded library (nvcc's `-Xptxas -v`
    report of the C2 kernel on the nvJPEG backend), or None."""
    _load()
    path = _STATE.get("path")
    if path is None or not os.path.exists(path[:-3] + ".log"):
        return None
    with open(path[:-3] + ".log", encoding="utf-8") as f:
        return f.read()


def _bind(lib: ctypes.CDLL, backend: str) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {"mml_jpeg_probe": [vp, i64, i32, i32p, i32p, i32p],
            "mml_jpeg_decode_bgr": [vp, i64, i32, vp, i64, i32p, i32p, i32p],
            "mml_jpeg_layout": [vp, i64, i32p],
            "mml_jpeg_decode_planes": [vp, i64, vp, i64]}
    if backend == "nvjpeg":
        sigs["mml_ycc_to_bgr"] = [vp, vp, vp, i32p, i32p, i32, i32, i32, vp,
                                  vp]
        lib.mml_ycc_launches.argtypes = []
        lib.mml_ycc_launches.restype = i64
        lib.mml_ycc_reset_launches.argtypes = []
        lib.mml_ycc_reset_launches.restype = None
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32


def _load() -> Optional[ctypes.CDLL]:
    """The decoder library, built and loaded at the first call; None
    where the machine has neither backend's headers (the reason is
    `build_error()`).  A backend that is there but fails to build raises
    DecoderError, at this call and every later one."""
    with _LOCK:
        if not _STATE:
            lib, backend, error, path = None, None, None, None
            cxx = shutil.which("g++") or shutil.which("c++")
            choice = _choose(cxx) if cxx else None
            if choice is None:
                error = ("no C++ compiler" if not cxx else "neither "
                         "jpeglib.h nor the CUDA toolkit's nvjpeg.h found")
            else:
                backend = choice[0]
                try:
                    path = _build(*choice)
                    lib = ctypes.CDLL(path)
                    _bind(lib, backend)
                except (RuntimeError, OSError,
                        subprocess.SubprocessError) as e:
                    error = f"the {backend} decoder did not build: {e}"
                    lib = path = None
            _STATE.update(lib=lib, backend=backend, error=error, path=path)
        if _STATE["lib"] is None and _STATE["backend"] is not None:
            raise DecoderError(_STATE["error"])
        return _STATE["lib"]


def jpeg_available() -> bool:
    """True when a JPEG decoder library is built and loaded."""
    return _load() is not None


def jpeg_backend() -> Optional[str]:
    """"libjpeg", "nvjpeg", or None where the machine has neither."""
    _load()
    return _STATE["backend"]


def build_error() -> Optional[str]:
    """Why no decoder library is loaded (None when one is)."""
    try:
        _load()
    except DecoderError:
        pass
    return _STATE["error"]


def _check_scale(scale_denom: int) -> None:
    if scale_denom != 1 and jpeg_backend() == "nvjpeg":
        raise ValueError(f"scale_denom {scale_denom}: nvJPEG has no "
                         "DCT-domain scaling (the libjpeg backend does)")


# the C entries' codes that are the decoder's failures, not the stream's
_FAILURES = {-5: "failed on the card or in nvJPEG (no handle, stream or "
                 "device memory, an nvJPEG error, or the C2 kernel)",
             -6: "got sizes from nvJPEG that disagree with the stream's "
                 "header"}


def _check_rc(rc: int, what: str) -> int:
    """`rc`, unless it is a failure of the decoder: that raises."""
    if rc in _FAILURES:
        raise DecoderError(f"a JPEG {what} {_FAILURES[rc]} (code {rc})")
    return rc


def _probe(lib, buf: np.ndarray, scale_denom: int):
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = _check_rc(lib.mml_jpeg_probe(buf.ctypes.data, len(buf),
                                      int(scale_denom), ctypes.byref(h),
                                      ctypes.byref(w), ctypes.byref(c)),
                   "probe")
    if rc != 0 or h.value * w.value > MAX_JPEG_PIXELS:
        return None
    return (h.value, w.value, c.value)


def _decode(lib, buf: np.ndarray, scale_denom: int, out: np.ndarray):
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = _check_rc(lib.mml_jpeg_decode_bgr(
        buf.ctypes.data, len(buf), int(scale_denom), out.ctypes.data,
        out.nbytes, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)),
        "decode")
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
    channel); None when no decoder is built or the stream is refused (a
    failure of the decoder raises `DecoderError`).
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
    Returns False on a shape mismatch or a refused stream (the caller
    decodes it another way or drops the row); a failure of the decoder
    raises `DecoderError`."""
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


class JpegLayout(NamedTuple):
    """What a stream's header says: size, components, colour space (0
    gray, 1 YCbCr, 2 RGB, -1 another) and each component's (h, v)
    sampling factors."""

    height: int
    width: int
    color: int
    factors: Tuple[Tuple[int, int], ...]

    def plane_shapes(self) -> List[Tuple[int, int]]:
        """Each component plane's real (rows, columns): the image size
        times the factor over the largest factor, rounded up (libjpeg's
        downsampled_height / _width)."""
        hmax = max(h for h, _ in self.factors)
        vmax = max(v for _, v in self.factors)
        return [(-(-self.height * v // vmax), -(-self.width * h // hmax))
                for h, v in self.factors]


def jpeg_layout(data: bytes) -> Optional[JpegLayout]:
    """The stream's layout read from its header; None when no decoder is
    built or the header is bad."""
    lib = _load()
    if lib is None or not data:
        return None
    out = (ctypes.c_int32 * 10)()
    if lib.mml_jpeg_layout(np.frombuffer(data, np.uint8).ctypes.data,
                           len(data), out) != 0:
        return None
    n = out[0]
    return JpegLayout(out[1], out[2], out[3],
                      tuple((out[4 + 2 * c], out[5 + 2 * c])
                            for c in range(min(n, 3))))


def decode_jpeg_planes(data: bytes) -> Optional[Tuple[JpegLayout,
                                                      List[np.ndarray]]]:
    """(layout, [plane arrays]) of a gray or 3-component stream: each
    component at its real size as the IDCT gives it (libjpeg's
    `raw_data_out`; nvJPEG's planes), before upsampling and colour
    conversion.  None when no decoder is built, the stream is bad or has
    another component count."""
    lib = _load()
    layout = jpeg_layout(data)
    if layout is None or len(layout.factors) not in (1, 3) or \
            layout.height * layout.width > MAX_JPEG_PIXELS:
        return None
    shapes = layout.plane_shapes()
    out = np.empty(sum(h * w for h, w in shapes), np.uint8)
    rc = _check_rc(lib.mml_jpeg_decode_planes(
        np.frombuffer(data, np.uint8).ctypes.data, len(data), out.ctypes.data,
        out.nbytes), "plane decode")
    if rc != 0:
        return None
    planes, at = [], 0
    for h, w in shapes:
        planes.append(out[at:at + h * w].reshape(h, w))
        at += h * w
    return layout, planes


def ycc_library() -> ctypes.CDLL:
    """The nvJPEG backend's library, which holds the C2 kernel's entry
    (`mml_ycc_to_bgr`); raises where the decoder is not that backend."""
    lib = _load()
    if lib is None or _STATE["backend"] != "nvjpeg":
        raise DecoderError(
            "the C2 kernel lives in the nvJPEG decoder, and this machine's "
            f"decoder is {_STATE['backend']!r} ({_STATE['error']})")
    return lib


def ycc_launches() -> int:
    """Launches of the C2 kernel in this process since the last reset (0
    where the decoder is not the nvJPEG backend)."""
    lib = _load()
    return int(lib.mml_ycc_launches()) if _STATE["backend"] == "nvjpeg" \
        else 0


def reset_ycc_launches() -> None:
    """Set the C2 kernel's launch count to 0."""
    lib = _load()
    if _STATE["backend"] == "nvjpeg":
        lib.mml_ycc_reset_launches()
