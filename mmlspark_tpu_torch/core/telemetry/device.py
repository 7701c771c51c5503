"""Device-level observability: the compile sentry, device-memory gauges,
and opt-in `torch.profiler` annotations.

Counterpart of the JAX package's `core/telemetry/device.py`.  Everything
host-side in this package watches OUR code; this module watches the
runtime underneath it.  Three concerns:

* **Compile sentry** — what the port compiles is its hand-written
  kernels: each `nvcc` / `g++` build of `ops/_build.py` and of `native/`
  reports itself here (`note_build`).  No path of the port captures a
  CUDA graph or runs `torch.compile`, so nothing else compiles.  Once
  `track_compiles()` armed the sentry, every build is an `xla.compile`
  span — a child of the active trace when one is open — plus an
  `xla.compile.latency` observation and an `xla.compile.count` bump.
  After the caller DECLARES warmup over (`SENTRY.end_warmup()`), a build
  is flagged as a steady-state compile: `xla.compile.hot_path` counter +
  WARNING log.  The metric names are the JAX package's, so the fleet
  merge and the report tools read both packages alike.

  A steady-state recompile in the JAX package is a jitted function
  meeting a shape it never saw; the port's kernels take any shape, but a
  new shape at a step site still means the warmup missed one (a batch
  that was not padded, a bucket that was not declared).
  `watch_compiles(fn, name)` wraps the port's step and forward closures
  at the sites the JAX package wraps its jitted ones
  (`training.train_step`, `training.lm_train_step_3d`,
  `tpu_model.forward`, `image_stages.<Stage>`, `deep_vision.epoch`, ...):
  each call's abstract signature (`float32[8,224,224,3]`, the array-like
  top-level arguments) is kept, and a NEW signature counts
  `xla.compile.count`; in steady state it also counts
  `xla.compile.hot_path` and `xla.compile.hot_path.<name>` and emits a
  loud `log_verb` record + WARNING naming the shape.

* **Memory gauges** — `sample_device_memory()` reads
  `torch.cuda.memory_stats()` of each local card into
  `device.hbm.bytes_in_use` (allocated bytes now),
  `device.hbm.peak_bytes` (the allocator's peak) and
  `device.live_buffer_count` (live allocations), summed over the cards;
  a card whose allocator keeps no statistics reports `total - free`
  from `torch.cuda.mem_get_info()` as its bytes in use.  The sampler is
  PASSIVE: when CUDA was never initialised in this process it returns {}
  rather than be the call that claims a card.
  `start_memory_sampler(interval_s)` runs it on a daemon thread;
  `ServingServer` samples on every `/metrics` scrape.

* **Device annotations** — `enable_device_annotations()` arms the span
  layer so `span()` additionally enters a
  `torch.profiler.record_function` for matching span names
  (`training.step`, `pipeline.<stage>`, ...), and
  `device_annotation(name)` gives already-measured sites (the feed's
  copy, flow workers) the same opt-in wrapper.  Off by default: under a
  `torch.profiler` capture the trace then carries our span names.

This module imports no torch at module scope — the telemetry package
must stay importable (and `/metrics` servable) in processes that never
touch a device.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

from . import spans as _spans
from .goodput import LEDGER
from .metrics import REGISTRY
from .records import log_verb, logger

__all__ = ["CompileSentry", "SENTRY", "track_compiles", "watch_compiles",
           "describe_abstract_shapes", "note_build", "sample_device_memory",
           "MemorySampler", "start_memory_sampler",
           "enable_device_annotations", "device_annotation",
           "DEFAULT_ANNOTATION_PREFIXES"]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def describe_abstract_shapes(args: Iterable[Any],
                             kwargs: Optional[Dict[str, Any]] = None,
                             limit: int = 8) -> str:
    """'float32[8,224,224,3], int64[8]' for the array-like leaves among
    a call's top-level arguments — the signature a step site keys on.
    Non-array arguments (the train state, static config) are skipped:
    the data batch is what changes shape in practice."""
    parts = []
    values = list(args) + list((kwargs or {}).values())
    for v in values:
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None or dtype is None:
            continue
        try:
            dims = ",".join(str(int(d)) for d in shape)
        except (TypeError, ValueError):
            dims = str(shape)
        parts.append(f"{_dtype_name(dtype)}[{dims}]")
        if len(parts) >= limit:
            parts.append("...")
            break
    return ", ".join(parts) if parts else "<no array args>"


class CompileSentry:
    """Process-wide compile watcher.  Starts in WARMUP: builds are
    recorded (span + histogram + count) but expected.  After
    `end_warmup()` every build and every new signature at a watched
    site is a steady-state compile and is flagged loudly.  `reset()`
    returns to warmup (tests, or a planned reconfiguration)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._installed = False
        self._steady = False
        self._compiles = 0

    # ---- state ---------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Kernel builds seen since the sentry was armed."""
        with self._lock:
            return self._compiles

    @property
    def listener_active(self) -> bool:
        """True once armed: the build hook reports to this sentry."""
        with self._lock:
            return self._installed

    @property
    def in_warmup(self) -> bool:
        with self._lock:
            return not self._steady

    def end_warmup(self) -> None:
        """Declare warmup over: from here, any compile is a hot-path
        compile and gets flagged."""
        with self._lock:
            self._steady = True

    def reset(self) -> None:
        with self._lock:
            self._steady = False

    @contextlib.contextmanager
    def warmup(self):
        """Compiles inside the block are warmup; steady-state flagging
        (re-)arms when it exits."""
        with self._lock:
            self._steady = False
        try:
            yield self
        finally:
            self.end_warmup()

    # ---- installation --------------------------------------------------
    def install(self) -> "CompileSentry":
        """Idempotently arm the build hook (`note_build` reports to this
        sentry from then on)."""
        with self._lock:
            self._installed = True
        return self

    def on_build(self, name: str, duration: float) -> None:
        """A kernel library was built (`ops/_build.py`, `native/`):
        runs on the building thread, so the span lands in the trace of
        the call that needed the kernel."""
        with self._lock:
            if not self._installed:
                return
            self._compiles += 1
            steady = self._steady
        phase = "steady" if steady else "warmup"
        try:
            REGISTRY.incr("xla.compile.count")
            REGISTRY.histogram("xla.compile.latency").observe(float(duration))
            _spans.record_span("xla.compile", _spans.current_context(),
                               float(duration), phase=phase, kernel=name)
            # a build after training started is wall the run can never
            # get back — the goodput ledger drops this until its first
            # recorded step, so warmup stays unattributed
            LEDGER.note_lost("recompile", float(duration))
            if steady:
                REGISTRY.incr("xla.compile.hot_path")
                logger.warning(
                    "xla.compile.hot_path: steady-state kernel build of %s "
                    "(%.3fs) — a kernel the warmup never built was needed",
                    name, duration)
        except Exception:
            # a telemetry hook must never break a build
            pass

    # ---- wrapper-side reporting ----------------------------------------
    def note_traced_compile(self, name: str, args: tuple,
                            kwargs: Dict[str, Any]) -> None:
        """A `watch_compiles` wrapper met a new signature.  Counted as a
        compile; in steady state, the triggering shape is named loudly."""
        with self._lock:
            steady = self._steady
        REGISTRY.incr("xla.compile.count")
        if not steady:
            return
        shape = describe_abstract_shapes(args, kwargs)
        REGISTRY.incr("xla.compile.hot_path")
        REGISTRY.incr(f"xla.compile.hot_path.{name}")
        with log_verb(self, "hot_path_recompile", fn=name, shape=shape):
            pass
        logger.warning(
            "xla.compile.hot_path: %s met a new shape in steady state: %s "
            "— pad or bucket inputs so serving/training reuses the warmed "
            "shapes", name, shape)


SENTRY = CompileSentry()


def track_compiles() -> CompileSentry:
    """Arm the process-wide compile sentry (idempotent) and return it.
    Call once before warmup; call `.end_warmup()` when the shapes you
    intend to serve/train have all run."""
    return SENTRY.install()


def note_build(name: str, duration: float) -> None:
    """The build hook `ops/_build.py` and `native/` call after each
    compile; a no-op until the sentry is armed."""
    SENTRY.on_build(name, duration)


class _WatchedFunction:
    """Transparent proxy over a step or forward callable that reports new
    signatures to the sentry.  Attribute access passes through."""

    __slots__ = ("_fn", "_name", "_sentry", "_seen", "_lock")

    def __init__(self, fn, name: str, sentry: CompileSentry):
        self._fn = fn
        self._name = name
        self._sentry = sentry
        self._seen: set = set()
        self._lock = threading.Lock()

    @property
    def __wrapped__(self):
        return self._fn

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __call__(self, *args, **kwargs):
        sig = describe_abstract_shapes(args, kwargs, limit=64)
        with self._lock:
            new = sig not in self._seen
            self._seen.add(sig)
        if new:
            self._sentry.note_traced_compile(self._name, args, kwargs)
        return self._fn(*args, **kwargs)

    def __repr__(self) -> str:
        return f"watch_compiles({self._fn!r}, name={self._name!r})"


def watch_compiles(fn, name: str,
                   sentry: Optional[CompileSentry] = None):
    """Wrap a step or forward callable so steady-state new signatures
    are attributed to `name` and the triggering argument shapes.  Arms
    the sentry as a side effect (the wrapper and the build hook are two
    halves of one mechanism)."""
    s = sentry if sentry is not None else SENTRY
    s.install()
    return _WatchedFunction(fn, name, s)


# ---- memory gauges --------------------------------------------------------

def _cuda_if_initialized():
    """`torch.cuda`, or None when torch is not imported OR CUDA was never
    initialised in this process — a metrics scrape must stay passive and
    never be the call that claims a card."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:
        return None
    return torch.cuda


def sample_device_memory(devices=None) -> Dict[str, int]:
    """One best-effort sample of device memory into the gauges.

    Returns the sampled values ({} when CUDA is not initialised):
    `hbm_bytes_in_use` / `hbm_peak_bytes` / `live_buffer_count` summed
    over `devices` (default: every local card) from
    `torch.cuda.memory_stats` — `allocated_bytes.all.current`,
    `allocated_bytes.all.peak`, `allocation.all.current`; a card whose
    allocator keeps no statistics gives `total - free` from
    `torch.cuda.mem_get_info` for its bytes in use and peak."""
    cuda = _cuda_if_initialized()
    if cuda is None:
        return {}
    try:
        devs = (list(devices) if devices is not None
                else list(range(cuda.device_count())))
    except Exception:
        return {}
    bytes_in_use = peak_bytes = n_buffers = 0
    have = False
    for d in devs:
        try:
            stats = cuda.memory_stats(d)
        except Exception:
            stats = None
        if stats:
            used = int(stats.get("allocated_bytes.all.current", 0))
            bytes_in_use += used
            peak_bytes += int(stats.get("allocated_bytes.all.peak", used))
            n_buffers += int(stats.get("allocation.all.current", 0))
            have = True
            continue
        try:
            free, total = cuda.mem_get_info(d)
        except Exception:
            continue
        bytes_in_use += int(total) - int(free)
        peak_bytes += int(total) - int(free)
        have = True
    if not have:
        return {}
    REGISTRY.gauge("device.hbm.bytes_in_use").set(bytes_in_use)
    REGISTRY.gauge("device.hbm.peak_bytes").set(peak_bytes)
    REGISTRY.gauge("device.live_buffer_count").set(n_buffers)
    return {"hbm_bytes_in_use": bytes_in_use, "hbm_peak_bytes": peak_bytes,
            "live_buffer_count": n_buffers}


class MemorySampler:
    """Daemon thread sampling device memory every `interval_s`.  Also a
    context manager: `with MemorySampler(5.0): ...`."""

    def __init__(self, interval_s: float = 5.0, devices=None):
        self.interval_s = float(interval_s)
        self._devices = devices
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def start(self) -> "MemorySampler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="device-memory-sampler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if sample_device_memory(self._devices):
                    self.samples += 1
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def __enter__(self) -> "MemorySampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def start_memory_sampler(interval_s: float = 5.0,
                         devices=None) -> MemorySampler:
    return MemorySampler(interval_s, devices).start()


# ---- device annotations ---------------------------------------------------

# the stage spans worth seeing on a device timeline: the training step,
# the h2d transfer, and the host-pipeline stages
DEFAULT_ANNOTATION_PREFIXES: Tuple[str, ...] = (
    "training.step", "feed.transfer", "io.pipeline", "pipeline.")


def enable_device_annotations(
        enabled: bool = True,
        prefixes: Tuple[str, ...] = DEFAULT_ANNOTATION_PREFIXES) -> bool:
    """Opt in (or out) of wrapping matching spans in
    `torch.profiler.record_function` so a profiler capture shows our
    span names.  Returns True when armed."""
    if not enabled:
        _spans.set_annotation_hook(None, ())
        return False
    try:
        from torch.profiler import record_function
    except Exception:
        _spans.set_annotation_hook(None, ())
        return False
    _spans.set_annotation_hook(record_function, tuple(prefixes))
    return True


def device_annotation(name: str):
    """A `record_function` context for `name` when annotations are armed
    and the name matches, else a no-op context — for already-measured
    sites whose spans go through `record_span` and so never pass through
    `span()`'s hook."""
    factory, prefixes = _spans.get_annotation_hook()
    if factory is None or not prefixes or not name.startswith(prefixes):
        return contextlib.nullcontext()
    try:
        return factory(name)
    except Exception:
        return contextlib.nullcontext()
